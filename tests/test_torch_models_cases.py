"""The reference's encoder cases (tests/test_models.py) on the port:
parity with torch's BertModel (CLS and mean pooling) at a tiny random
config, the npz round trip, padding invariance, the full-size BGE-small
pipeline through models/convert.py and default_embedder, and the
embedder service, on the CPU.

Rewrites: the reference's bert_encode(params, cfg, ids, mask) runs a
jitted function of the param pytree; the port's takes the module that
holds the uploaded weights, so each call becomes
bert_encode(BertEncoder.from_params(params, cfg, device="cpu"), ids,
mask). JaxEncoderEmbedder is the port's TorchEncoderEmbedder;
it and default_embedder run with device="cpu".

Left out, by name:
  * TestEmbedderWrapper.test_batch_bucketing_is_value_transparent_and_reuses_programs:
    asserts the count of XLA programs the encoder compiled
    (`_forward._cache_size()`), which the port does not have.
"""

from torch_reference_cases import drop_cases, port_cases

exec(port_cases("test_models.py", [
    (r"from cortex_tpu\.models import \(BertEncoderConfig,",
     "from cortex_tpu.models import (BertEncoder, BertEncoderConfig,"),
    (r"\bbert_encode\((\w+), (\w+), ",
     r'bert_encode(BertEncoder.from_params(\1, \2, device="cpu"), '),
    (r"\bJaxEncoderEmbedder\b", "TorchEncoderEmbedder"),
], cpu_calls=(r"\bTorchEncoderEmbedder", r"\bdefault_embedder")),
     globals())

drop_cases(globals(), {
    "TestEmbedderWrapper."
    "test_batch_bucketing_is_value_transparent_and_reuses_programs":
        "asserts the XLA program cache of the encoder",
})


def test_cases_run_on_the_port():
    enc = BertEncoder.from_params(init_params(TINY), TINY,  # noqa: F821
                                  device="cpu")
    assert type(enc).__module__ == "cortex_tpu_torch.models.encoder"
