"""Data substrate: tokenizers, synthetic corpora, batch pipeline.

A copy of ``repro.data`` (numpy only), kept in the port so that it
imports nothing of the JAX package: seeded batches are bitwise the
JAX package's."""
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.data.synthetic import MarkovLanguage, TranslationTask, bleu
from repro_torch.data.tokenizer import ByteTokenizer, CharTokenizer

__all__ = ["DataConfig", "DataPipeline", "MarkovLanguage",
           "TranslationTask", "bleu", "ByteTokenizer", "CharTokenizer"]
