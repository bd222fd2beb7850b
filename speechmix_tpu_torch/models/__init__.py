"""Model modules of the port: speech encoder, seq2seq LM, SpeechMix fusion."""
