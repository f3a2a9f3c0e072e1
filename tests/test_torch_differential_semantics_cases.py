"""The reference's differential semantics cases
(tests/test_differential_semantics.py) on the port: briefings, prompt
resolution, selection and rollback, and linker rules. Their briefing
world (World, agent_world, mknode) comes from the port's run of the
reference's briefing cases (test_torch_briefing.py), not from
tests/test_briefing.py, so it is made of the port's objects."""

from torch_reference_cases import port_cases

exec(port_cases("test_differential_semantics.py", [
    (r"from test_briefing import", "from test_torch_briefing import"),
]), globals())


def test_cases_run_on_the_port():
    w = World()  # noqa: F821
    assert type(w.engine).__module__.startswith("cortex_tpu_torch.")
    assert MemoryStorage.__module__.startswith(  # noqa: F821
        "cortex_tpu_torch.")
