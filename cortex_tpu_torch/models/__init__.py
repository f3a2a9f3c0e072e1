from .encoder import (BertEncoder, BertEncoderConfig, bert_encode,
                      convert_hf_state_dict, init_params, load_npz, save_npz)

__all__ = ["BertEncoder", "BertEncoderConfig", "bert_encode",
           "convert_hf_state_dict", "init_params", "load_npz", "save_npz"]
