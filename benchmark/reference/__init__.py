"""The plain reference: SpeechMix (wav2vec2 + BART) and its training recipe
in plain PyTorch, float32, independent of the program under test."""
