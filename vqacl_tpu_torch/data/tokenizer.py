"""VL-T5 tokenizer: T5 sentencepiece + 100 ``<vis_extra_id_*>`` tokens.

The port's own copy of ``vqacl_tpu/data/tokenizer.py`` (same ids, same
API). Id layout, as in the reference VL-T5 ``tokenization.py``:
  sp pieces           0 .. 31999
  ``<extra_id_i>``    32099 - i      (i in 0..99)
  ``<vis_extra_id_i>``32199 - i      (i in 0..99)
  pad=0, eos=1 (``</s>`` appended by the post-processor), unk=2.

With a ``spiece.model`` the HF ``tokenizers`` Rust Unigram model does
the encoding; that package is imported only then. With
``vocab_file=None`` a deterministic hash-based word tokenizer over the
same id space takes its place (tests, synthetic serving): stable ids
across processes, and equal to the JAX package's fallback.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Dict, List, Optional, Sequence, Tuple

SP_VOCAB = 32000
N_EXTRA = 100
N_VIS = 100
VOCAB_SIZE = SP_VOCAB + N_EXTRA + N_VIS  # 32200

PAD_ID, EOS_ID, UNK_ID = 0, 1, 2


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _read_varint(buf, pos)
    elif wire == 2:
        length, pos = _read_varint(buf, pos)
        pos += length
    elif wire == 5:
        pos += 4
    elif wire == 1:
        pos += 8
    else:
        raise ValueError(f"bad wire type {wire}")
    return pos


def parse_spiece_model(path: str) -> List[Tuple[str, float]]:
    """(piece, score) in id order from a sentencepiece model file.

    ModelProto: field 1 = repeated SentencePiece{1: piece (string),
    2: score (float), 3: type (enum)}; unknown fields are skipped.
    """
    with open(path, "rb") as f:
        buf = f.read()
    pieces: List[Tuple[str, float]] = []
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if not (field == 1 and wire == 2):
            pos = _skip(buf, pos, wire)
            continue
        length, pos = _read_varint(buf, pos)
        sub = buf[pos:pos + length]
        pos += length
        piece, score, spos = "", 0.0, 0
        while spos < len(sub):
            stag, spos = _read_varint(sub, spos)
            sfield, swire = stag >> 3, stag & 7
            if sfield == 1 and swire == 2:
                slen, spos = _read_varint(sub, spos)
                piece = sub[spos:spos + slen].decode("utf-8")
                spos += slen
            elif sfield == 2 and swire == 5:
                score = struct.unpack("<f", sub[spos:spos + 4])[0]
                spos += 4
            else:
                spos = _skip(sub, spos, swire)
        pieces.append((piece, score))
    return pieces


class VLT5Tokenizer:
    """Encode/decode with the VL-T5 id space. See module docstring."""

    def __init__(self, vocab_file: Optional[str] = None,
                 extra_ids: int = N_EXTRA, vis_extra_ids: int = N_VIS):
        self._extra_ids = extra_ids
        self._vis_extra_ids = vis_extra_ids
        self._fallback_vocab: Dict[int, str] = {}
        self._tok = None
        if vocab_file is not None:
            self._tok = self._build_unigram(vocab_file)

    @property
    def vocab_size(self) -> int:
        return SP_VOCAB + self._extra_ids + self._vis_extra_ids

    @property
    def pad_token_id(self) -> int:
        return PAD_ID

    @property
    def eos_token_id(self) -> int:
        return EOS_ID

    def extra_id(self, i: int) -> int:
        return self.vocab_size - i - 1 - self._vis_extra_ids

    def vis_extra_id(self, i: int) -> int:
        return self.vocab_size - i - 1

    def _build_unigram(self, vocab_file: str):
        from tokenizers import Tokenizer, decoders, normalizers, pre_tokenizers
        from tokenizers import processors
        from tokenizers.models import Unigram

        vocab = list(parse_spiece_model(vocab_file))
        vocab += [(f"<extra_id_{i}>", 0.0)
                  for i in range(self._extra_ids - 1, -1, -1)]
        vocab += [(f"<vis_extra_id_{i}>", 0.0)
                  for i in range(self._vis_extra_ids - 1, -1, -1)]
        tok = Tokenizer(Unigram(vocab, unk_id=UNK_ID, byte_fallback=False))
        # T5's exact normalizer is a precompiled charsmap in the sp model;
        # NFKC + newline folding is equivalent for English VQA questions
        tok.normalizer = normalizers.Sequence([
            normalizers.Replace("\n", " "),
            normalizers.NFKC(),
        ])
        tok.pre_tokenizer = pre_tokenizers.Metaspace()
        tok.decoder = decoders.Metaspace()
        tok.post_processor = processors.TemplateProcessing(
            single=["$A", "</s>"], pair=["$A", "</s>", "$B", "</s>"],
            special_tokens=[("</s>", EOS_ID)])
        return tok

    @staticmethod
    def _hash_word(word: str) -> int:
        h = int.from_bytes(hashlib.md5(word.encode()).digest()[:8], "little")
        return 3 + h % (SP_VOCAB - 3)

    def _fallback_encode(self, text: str) -> List[int]:
        ids = []
        for w in text.lower().split():
            i = self._hash_word(w)
            self._fallback_vocab[i] = w
            ids.append(i)
        return ids

    def encode(self, text: str, max_length: Optional[int] = None,
               truncation: bool = True) -> List[int]:
        """→ ids ending in EOS, truncated to ``max_length`` after the EOS
        is appended (HF ``encode(..., truncation=True)`` semantics)."""
        if self._tok is not None:
            ids = self._tok.encode(text).ids
        else:
            ids = self._fallback_encode(text) + [EOS_ID]
        if truncation and max_length is not None and len(ids) > max_length:
            ids = ids[:max_length]
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True
               ) -> str:
        ids = [int(i) for i in ids]
        if skip_special_tokens:
            ids = [i for i in ids
                   if i not in (PAD_ID, EOS_ID, UNK_ID) and i < SP_VOCAB]
        if self._tok is not None:
            return self._tok.decode(ids, skip_special_tokens=False).strip()
        return " ".join(self._fallback_vocab.get(i, "<unk>") for i in ids)

    def batch_decode(self, batch_ids, skip_special_tokens: bool = True
                     ) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch_ids]
