from celebbasis_tpu_torch.text.tokenizer import CLIPTokenizer, SyntheticVocab

__all__ = ["CLIPTokenizer", "SyntheticVocab"]
