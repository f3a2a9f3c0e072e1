"""Run one of the reference's test modules on the port.

`port_cases(name, rewrites)` reads tests/<name>, points every import of
cortex_tpu at cortex_tpu_torch (the CLI's, which the port does not have,
excepted: a test may import it for its example config), applies the
given (old, new) rewrites, which place the port's device-bound objects
on the CPU, and returns the compiled module. A test file execs it into
its own namespace, so pytest collects the reference's cases, unchanged
but for those lines, as the port's. A rewrite that no longer matches
fails loudly: the reference's file changed and the port's copy of its
cases must be looked at again.
"""

import re
from pathlib import Path

TESTS = Path(__file__).resolve().parent
_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)cortex_tpu\b(?!\.cli\b)",
                     re.M)


def port_cases(name, rewrites=()):
    path = TESTS / name
    src = path.read_text()
    for old, new in rewrites:
        got = re.subn(old, new, src)
        if got[1] == 0:
            raise AssertionError(f"{name}: no line matches {old!r}")
        src = got[0]
    src = _IMPORT.sub(r"\1cortex_tpu_torch", src)
    return compile(src, str(path), "exec")
