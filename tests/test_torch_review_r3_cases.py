"""The reference's round-3 review cases (tests/test_review_r3.py) on the
port: snapshot deltas after a boot rebuild, the IVF index's TOML keys,
the HTTP batcher's fallback, SQL variable-limit chunking, IVF padding of
a small pool and the NATS URL's credentials. Every Cortex and index on
the CPU (device="cpu"). Rewrites: the HTTP scenario is the port's run of
the reference's HTTP cases (test_torch_http.py), not tests/test_http.py,
and the hybrid module the cases load by name is the port's."""

from torch_reference_cases import port_cases

exec(port_cases("test_review_r3.py", [
    (r"\bTpuIvfIndex\b", "TorchIvfIndex"),
    (r"from tests\.test_http import scenario",
     "from test_torch_http import scenario"),
    (r'"cortex_tpu\.vector\.hybrid"', '"cortex_tpu_torch.vector.hybrid"'),
], cpu_calls=(r"\bCortex\.in_memory", r"\bCortex\.open",
              r"\bTorchIvfIndex")), globals())


def test_cases_run_on_the_port():
    cx = Cortex.in_memory(device="cpu")  # noqa: F821
    assert type(cx).__module__ == "cortex_tpu_torch.api"
    cx.close()
