from repro_torch.data.dataset import MathDataset, MathSample, PromptDataset
from repro_torch.data.tokenizer import ByteTokenizer

__all__ = ["ByteTokenizer", "MathDataset", "MathSample", "PromptDataset"]
