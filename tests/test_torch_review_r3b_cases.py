"""The reference's round-3b review cases (tests/test_review_r3b.py) on the
port: the MCP backend's gate and prompts, the event bus, the encoder's
config, the briefing cache, the encrypted store's guard, the query DSL
and the server's clean-up after a failed boot, every Cortex and the
server on the CPU (device="cpu"). Left out, by name:

  * TestSdkClientFixes.test_open_with_db_file_path and
    TestSdkClientFixes.test_embedded_gate_matches_remote_semantics: the
    Python SDK's embedded mode (sdks/python/cortex_memory/client.py:49)
    imports cortex_tpu.api, so it opens only the JAX package.
"""

from torch_reference_cases import drop_cases, port_cases

exec(port_cases("test_review_r3b.py", cpu_calls=(
    r"\bCortex\.in_memory", r"\bserve_mod\.run")), globals())

drop_cases(globals(), {
    "TestSdkClientFixes.test_open_with_db_file_path":
        "the SDK's embedded mode opens only cortex_tpu",
    "TestSdkClientFixes.test_embedded_gate_matches_remote_semantics":
        "the SDK's embedded mode opens only cortex_tpu",
})


def test_cases_run_on_the_port():
    cx = Cortex.in_memory(device="cpu")  # noqa: F821
    assert type(cx).__module__ == "cortex_tpu_torch.api"
    cx.close()
