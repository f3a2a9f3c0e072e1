"""The reference's Python SDK cases (tests/test_sdk_python.py) on the
port: the SDK's mock and its remote client, and the MCP server's remote
backend, against the port's composed server on the CPU
(Server(..., device="cpu")). Left out, by name:

  * TestEmbedded.test_open_store_search_roundtrip,
    TestEmbedded.test_hybrid_and_briefing and
    TestRestClient.test_embedded_briefing_full: the SDK's embedded mode
    (sdks/python/cortex_memory/client.py:49) imports cortex_tpu.api, so
    it opens only the JAX package.
"""

from torch_reference_cases import drop_cases, port_cases

exec(port_cases("test_sdk_python.py",
                cpu_calls=(r"(?<![\w.])Server",)), globals())

drop_cases(globals(), {
    "TestEmbedded.test_open_store_search_roundtrip":
        "the SDK's embedded mode opens only cortex_tpu",
    "TestEmbedded.test_hybrid_and_briefing":
        "the SDK's embedded mode opens only cortex_tpu",
    "TestRestClient.test_embedded_briefing_full":
        "the SDK's embedded mode opens only cortex_tpu",
})

