"""Tokenizers (port of ``speechmix_tpu.data.tokenizer``).

* ``ByteTokenizer``: a byte-level tokenizer that needs no downloads, with
  a BART-compatible special-token layout (configurable ids).
* ``HFTokenizerAdapter``: a locally available HuggingFace tokenizer behind
  the same small interface (``transformers`` is imported only here, and
  only local files are read).

Interface: encode(text, add_special_tokens, add_eos) -> list[int];
decode(ids, skip_special_tokens) -> str; pad / bos / eos ids; vocab_size.
"""

from __future__ import annotations

from typing import List, Optional, Sequence


class ByteTokenizer:
    """Byte-level tokenizer.

    Layout (vocab_size >= 384):
      0: <pad>   1: <eos>   2: <bos>   3..127: reserved sentinels
      128..383: bytes 0..255
    (the special ids are arguments, e.g. BART's pad 1, eos 2, bos 0).
    """

    BYTE_OFFSET = 128

    def __init__(self, pad_token_id=0, eos_token_id=1, bos_token_id=2,
                 vocab_size=384):
        assert vocab_size >= self.BYTE_OFFSET + 256
        self.pad_token_id = pad_token_id
        self.eos_token_id = eos_token_id
        self.bos_token_id = bos_token_id
        self.vocab_size = vocab_size
        self._special = {pad_token_id, eos_token_id, bos_token_id}

    def encode(self, text: str, add_special_tokens: bool = True,
               add_eos: Optional[bool] = None) -> List[int]:
        ids = [b + self.BYTE_OFFSET for b in text.encode("utf-8")]
        if add_eos if add_eos is not None else add_special_tokens:
            ids = ids + [self.eos_token_id]
        return ids

    def __call__(self, text, add_special_tokens=True):
        if isinstance(text, str):
            return {"input_ids": self.encode(text, add_special_tokens)}
        return {"input_ids": [self.encode(t, add_special_tokens)
                              for t in text]}

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        by = bytearray()
        for i in ids:
            i = int(i)
            # ids outside the byte range have no text form (specials,
            # sentinels, and any id a raw argmax can give below vocab_size)
            if not self.BYTE_OFFSET <= i < self.BYTE_OFFSET + 256 \
                    or i in self._special:
                continue
            by.append(i - self.BYTE_OFFSET)
        return by.decode("utf-8", errors="ignore")

    def batch_decode(self, batch, skip_special_tokens: bool = True):
        return [self.decode(ids, skip_special_tokens) for ids in batch]


class HFTokenizerAdapter:
    """A locally cached HuggingFace tokenizer (no hub access; construction
    fails offline when the files are absent)."""

    def __init__(self, name_or_path: str):
        from transformers import AutoTokenizer
        self._tok = AutoTokenizer.from_pretrained(name_or_path,
                                                  local_files_only=True)
        self.pad_token_id = self._tok.pad_token_id
        self.eos_token_id = self._tok.eos_token_id
        self.bos_token_id = self._tok.bos_token_id
        self.vocab_size = len(self._tok)

    def encode(self, text, add_special_tokens=True, add_eos=None):
        return self._tok(text,
                         add_special_tokens=add_special_tokens)["input_ids"]

    def __call__(self, text, add_special_tokens=True):
        return self._tok(text, add_special_tokens=add_special_tokens)

    def decode(self, ids, skip_special_tokens=True):
        return self._tok.decode([int(i) for i in ids],
                                skip_special_tokens=skip_special_tokens)

    def batch_decode(self, batch, skip_special_tokens=True):
        return [self.decode(ids, skip_special_tokens) for ids in batch]


def load_tokenizer(name_or_path: str, decoder_config=None):
    """The byte tokenizer for byte-vocab configs and the test presets, else
    the local HF tokenizer.  When that is unavailable, a byte tokenizer with
    the decoder config's pad / eos / bos ids (so labels and generation stop
    on the same EOS), with a warning: its text differs from the real
    tokenizer's for a non-byte vocabulary."""
    if name_or_path in ("bytes", "byte", "byt5-small", "tiny-bart-bytes",
                        "tiny-t5-bytes"):
        if decoder_config is not None:
            return ByteTokenizer(pad_token_id=decoder_config.pad_token_id,
                                 eos_token_id=decoder_config.eos_token_id,
                                 bos_token_id=decoder_config.bos_token_id)
        return ByteTokenizer()
    try:
        return HFTokenizerAdapter(name_or_path)
    except Exception:
        import warnings
        kw = {}
        if decoder_config is not None:
            kw = dict(pad_token_id=decoder_config.pad_token_id,
                      eos_token_id=decoder_config.eos_token_id,
                      bos_token_id=decoder_config.bos_token_id,
                      vocab_size=max(decoder_config.vocab_size,
                                     ByteTokenizer.BYTE_OFFSET + 256))
        warnings.warn(
            f"no local HF tokenizer for {name_or_path!r}; falling back to "
            "the byte tokenizer" +
            (" with the decoder config's special-token ids" if kw else "") +
            " — decoded text will differ from the real tokenizer")
        return ByteTokenizer(**kw)
