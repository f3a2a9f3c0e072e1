"""The reference's nprobe tuner cases (tests/test_ivf_tune.py) on the port:
the tuner's direction, persistence and delivered recall, on the CPU, the
sharded tuner on a mesh of eight `cpu` devices (the reference's
build_mesh() is its eight virtual host devices), the port's
BruteForceIndex as the oracle."""

from torch_reference_cases import port_cases

exec(port_cases("test_ivf_tune.py", [
    (r"\bTpuIvfIndex\b", "TorchIvfIndex"),
    (r"build_mesh\(\)", 'build_mesh(8, devices=["cpu"] * 8)'),
], cpu_calls=(r"\bTorchIvfIndex",)), globals())


def test_cases_run_on_the_port():
    assert BruteForceIndex.__module__ == "cortex_tpu_torch.vector.index"  # noqa: F821
    assert IvfCorpus.__module__ == "cortex_tpu_torch.vector.ivf"  # noqa: F821
