"""The reference's review cases of its sixth pass (tests/test_review_r3c.py)
run on the port: tombstones in traversals, paths and components, the
timeline's recency (graph/temporal.py), the tokenizer's special tokens
and the viz page's escaping.

Every Cortex runs on the CPU (device="cpu"). Every assertion is the
reference's.
"""

from torch_reference_cases import port_cases

exec(port_cases("test_review_r3c.py", cpu_calls=(r"\bCortex\.in_memory",)),
     globals())


def test_cases_run_on_the_port():
    assert Cortex.__module__.startswith("cortex_tpu_torch."), Cortex  # noqa: F821
    from cortex_tpu_torch.graph.temporal import timeline
    assert timeline.__module__ == "cortex_tpu_torch.graph.temporal"
