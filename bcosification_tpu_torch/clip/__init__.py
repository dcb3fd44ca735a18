"""CLIP on PyTorch: the towers, the tokenizer and the checkpoint loader
(counterpart of ``bcosification_tpu/clip``)."""
from bcosification_tpu_torch.clip import model
from bcosification_tpu_torch.clip.load import available_models, load, load_state_dict_file
from bcosification_tpu_torch.clip.tokenizer import SimpleTokenizer, tokenize

__all__ = ["SimpleTokenizer", "available_models", "load", "load_state_dict_file", "model",
           "tokenize"]
