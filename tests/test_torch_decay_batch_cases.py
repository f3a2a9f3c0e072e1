"""The reference's batched decay cases (tests/test_decay_batch.py) on the
port: the decay engine on the port's MemoryStorage and SqliteStorage,
the linker's routing of decay to the worker process (the port's,
cortex_tpu_torch.linker.decay_worker), every flat index on the CPU."""

from torch_reference_cases import port_cases

exec(port_cases("test_decay_batch.py", [
    (r"\bTpuFlatIndex\b", "TorchFlatIndex"),
], cpu_calls=(r"\bTorchFlatIndex",)), globals())


def test_cases_run_on_the_port():
    assert DecayEngine.__module__ == "cortex_tpu_torch.linker.decay"  # noqa: F821
