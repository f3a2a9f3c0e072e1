"""The reference's IVF differential fuzzer (tests/test_ivf_fuzz.py) on the
port: TorchIvfIndex at full probe on the CPU and ShardedIvfIndex on a
mesh of eight `cpu` devices, through random upserts, removes, updates,
rebuilds and searches, against the port's BruteForceIndex."""

from torch_reference_cases import port_cases

exec(port_cases("test_ivf_fuzz.py", [
    (r"\bTpuIvfIndex\b", "TorchIvfIndex"),
    (r"build_mesh\(8\)", 'build_mesh(8, devices=["cpu"] * 8)'),
], cpu_calls=(r"\bTorchIvfIndex",)), globals())


def test_cases_run_on_the_port():
    assert BruteForceIndex.__module__ == "cortex_tpu_torch.vector.index"  # noqa: F821
    assert TorchIvfIndex.__module__ == "cortex_tpu_torch.vector.ivf"  # noqa: F821
