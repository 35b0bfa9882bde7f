from .pipeline import GzipCorpusDataset, PipelineState
from .tokenizer import BOS, EOS, PAD, ByteTokenizer

__all__ = ["BOS", "ByteTokenizer", "EOS", "GzipCorpusDataset", "PAD", "PipelineState"]
