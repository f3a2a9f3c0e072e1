"""Run one of the reference's test modules on the port.

`port_cases(name, rewrites, cpu_calls)` reads tests/<name>, points every
import of cortex_tpu at cortex_tpu_torch, applies the given (old, new)
regex rewrites, adds `device="cpu"` to every call of each name in
`cpu_calls` (the port's entry points default to the card), and returns
the compiled module. A test file execs it into its own namespace, so
pytest collects the reference's cases, unchanged but for those lines, as
the port's. A rewrite or a call name that no longer matches fails
loudly: the reference's file changed and the port's copy of its cases
must be looked at again.

`drop_cases(namespace, reasons)` removes the cases a port file leaves
out, each named ("Class.test" or "test") with its reason; a name that is
not there fails.

`CLI_ON_CPU` is the rewrite that runs the reference's in-process CLI
calls, main([...]), with the port's `--device cpu`.

`storage` is tests/conftest.py's fixture of that name on the port's
MemoryStorage and SqliteStorage: a port file that imports it runs the
reference's storage cases on the port's stores, not the reference's.
"""

import re
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)cortex_tpu\b", re.M)

CLI_ON_CPU = ((r"\bmain\(\[", 'main(["--device", "cpu", '),)


def _close_paren(src, start):
    """Index of the parenthesis closing the one before `start`."""
    depth, i, quote = 1, start, None
    while depth:
        c = src[i]
        if quote:
            if c == "\\":
                i += 1
            elif c == quote:
                quote = None
        elif c in "\"'":
            quote = c
        elif c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        i += 1
    return i - 1


def _on_cpu(src, callee, name):
    """Add device="cpu" to every call of `callee` (a regex ending at the
    call's opening parenthesis)."""
    out, pos, n = [], 0, 0
    for m in re.finditer(callee + r"\(", src):
        if m.start() < pos:
            continue
        end = _close_paren(src, m.end())
        args = src[m.end():end]
        sep = ", " if args.strip() else ""
        out.append(src[pos:end] + sep + 'device="cpu"')
        pos = end
        n += 1
    if n == 0:
        raise AssertionError(f"{name}: no call matches {callee!r}")
    out.append(src[pos:])
    return "".join(out)


def port_cases(name, rewrites=(), cpu_calls=()):
    path = TESTS / name
    src = path.read_text()
    for old, new in rewrites:
        got = re.subn(old, new, src)
        if got[1] == 0:
            raise AssertionError(f"{name}: no line matches {old!r}")
        src = got[0]
    for callee in cpu_calls:
        src = _on_cpu(src, callee, name)
    src = _IMPORT.sub(r"\1cortex_tpu_torch", src)
    return compile(src, str(path), "exec")


def drop_cases(ns, reasons):
    for case in reasons:
        owner, _, test = case.rpartition(".")
        if owner:
            assert test in vars(ns[owner]), case
            delattr(ns[owner], test)
        else:
            assert test in ns, case
            del ns[test]


@pytest.fixture(params=["memory", "sqlite"])
def storage(request, tmp_path):
    from cortex_tpu_torch.storage import MemoryStorage, SqliteStorage
    if request.param == "memory":
        yield MemoryStorage()
    else:
        s = SqliteStorage(str(tmp_path / "test.db"))
        yield s
        s.close()
