"""The reference's vector cases (tests/test_vector.py) on the port: the
flat index against the port's BruteForceIndex (exact, quant, approx and
bf16 storage, the quant-only residency, oversized filters, the sharded
index on a mesh of eight `cpu` devices), the embedders and the score
decay, every index and Cortex on the CPU.

Rewrites: the storage dtype the config plumbs is compared with
torch.bfloat16 (the reference: jnp.bfloat16); the reference's sharded
mesh is min(8, len(jax.devices())) = its eight virtual host devices,
here eight `cpu` devices."""

from torch_reference_cases import port_cases

exec(port_cases("test_vector.py", [
    (r"\bTpuFlatIndex\b", "TorchFlatIndex"),
    (r"import jax\.numpy as jnp\n", "import torch\n"),
    (r"== jnp\.bfloat16", "== torch.bfloat16"),
    (r"\n\s+import jax\n(\s+)mesh = build_mesh\(min\(8, len\(jax\.devices\(\)\)\)\)",
     r'\n\1mesh = build_mesh(8, devices=["cpu"] * 8)'),
], cpu_calls=(r"\bTorchFlatIndex", r"\bCortex\.in_memory")), globals())


def test_cases_run_on_the_port(filled):  # noqa: F811
    tpu, bf, _ = filled
    assert type(tpu).__module__ == "cortex_tpu_torch.vector.index"
    assert str(tpu._corpus._device) == "cpu"
    assert type(bf).__name__ == "BruteForceIndex"
    assert type(bf).__module__ == "cortex_tpu_torch.vector.index"
