"""Data pipeline of the port: audio, tokenizers, collation and bucketing,
teacher targets, datasets and the device prefetcher."""
