"""The reference's prompt cases (tests/test_prompt.py, 31 tests) run on
the port.

The port's prompt modules are copies of the reference's, but for their
imports; the cases are host Python over the port's MemoryStorage.
Every assertion is the reference's.
"""

from torch_reference_cases import port_cases

exec(port_cases("test_prompt.py"), globals())


def test_cases_run_on_the_port():
    for obj in (PromptResolver, RollbackMonitor, PromptContent,  # noqa: F821
                MemoryStorage, PromptError, Node):  # noqa: F821
        assert obj.__module__.startswith("cortex_tpu_torch."), obj
