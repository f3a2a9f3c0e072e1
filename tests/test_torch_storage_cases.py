"""The reference's storage cases (tests/test_storage.py) on the port's
MemoryStorage and SqliteStorage. Their `storage` fixture is the port's
(torch_reference_cases.storage), which takes the place of
tests/conftest.py's, so every case opens the port's stores."""

from torch_reference_cases import port_cases, storage  # noqa: F401

exec(port_cases("test_storage.py"), globals())


def test_cases_run_on_the_port(storage):  # noqa: F811
    assert type(storage).__module__.startswith("cortex_tpu_torch.storage")
    assert InvalidEdge.__module__ == "cortex_tpu_torch.errors"  # noqa: F821
