"""The reference's type cases (tests/test_types.py) on the port's copy of
types.py, and the account of every reference test module.

Each reference module under tests/ runs on the port through
torch_reference_cases.port_cases, in a tests/test_torch_*.py file of its
own, except these, which are not run:

  * test_device_grow: the device corpus's growth by donated XLA buffers
    and its compile warmers.
  * test_scatter_bucket: XLA's scatter buckets (one program a bucket).
  * test_fetch_redispatch: re-dispatch after a TPU fetch timeout
    (DeviceFetchTimeout, which the port does not have).
  * test_dispatch_races: races of JAX dispatch on donated buffers.
  * test_donation_race: XLA buffer donation under concurrent searches.
  * test_device_preflight: the TPU preflight probe (preflight_device).
  * test_ops_similarity: the reference's XLA similarity programs; the
    port's counterpart is test_torch_flat_ops.py.
  * test_ivf_gather: the Pallas kernel in interpret mode; the port's
    counterpart is test_torch_ivf_gather.py.
  * test_bench_contract, test_bench_smoke: the reference's benchmark
    (bench.py), which imports jax.
  * test_real_model_contract: slow (real BGE weights).
  * test_sdk_offline_gate: imports neither package.

test_every_reference_module_is_accounted_for fails when a reference
module is neither run nor named here.
"""

import re
from pathlib import Path

from torch_reference_cases import port_cases

exec(port_cases("test_types.py"), globals())

NOT_RUN = {
    "test_device_grow", "test_scatter_bucket", "test_fetch_redispatch",
    "test_dispatch_races", "test_donation_race", "test_device_preflight",
    "test_ops_similarity", "test_ivf_gather", "test_bench_contract",
    "test_bench_smoke", "test_real_model_contract", "test_sdk_offline_gate",
}


def test_cases_run_on_the_port():
    assert Node.__module__ == "cortex_tpu_torch.types"  # noqa: F821


def test_every_reference_module_is_accounted_for():
    here = Path(__file__).resolve().parent
    ported = set()
    for f in here.glob("test_torch_*.py"):
        ported |= set(re.findall(r'port_cases\(\s*"(test_\w+)\.py"',
                                 f.read_text()))
    reference = {f.stem for f in here.glob("test_*.py")
                 if not f.stem.startswith("test_torch_")}
    assert reference - ported - NOT_RUN == set()
    assert ported & NOT_RUN == set()
    assert NOT_RUN <= reference
