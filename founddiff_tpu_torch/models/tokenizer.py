"""CLIP byte-pair-encoding tokenizer and the Dose-CLIP prompt bootstrap
(mirror of ``founddiff_tpu/models/tokenizer.py``; the OpenAI CLIP
``SimpleTokenizer`` the reference calls through ``clip.tokenize``,
src/DACLIP.py:874, 906-926).

Lower-case and HTML-unescape, the CLIP pre-tokenization pattern, the
byte-to-unicode table, greedy lowest-rank BPE merges with the ``</w>``
end-of-word marker, and SOT/EOT framing to ``context_length`` ids.

The pattern's letter and number classes (``\\p{L}``, ``\\p{N}``) are built
for the standard library's ``re`` from ``unicodedata``: the code points of
the categories ``L*`` and ``N*`` as ranges, made once at first use.  The
``regex`` package is not needed.  ``[^\\W\\d_]`` would not do for a letter: it
also takes ``No`` and ``Nl`` characters such as ``²``, ``½`` and ``Ⅻ``.  The
classes follow Python's Unicode database (15.0 in Python 3.12); a character
assigned only in a later version, which ``regex`` may know, is unassigned
here.

The merge table is data (``bpe_simple_vocab_16e6.txt.gz``, the first 48894
merges), read from an explicit ``bpe_path``, then ``$FOUNDDIFF_CLIP_BPE``,
then ``~/.cache/clip/bpe_simple_vocab_16e6.txt.gz``.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import sys
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np

SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"


def _ranges(cps) -> str:
    """Sorted code points as the ranges of a ``re`` character class."""
    parts = []
    for cp in cps:
        if parts and parts[-1][1] == cp - 1:
            parts[-1][1] = cp
        else:
            parts.append([cp, cp])
    esc = lambda cp: f"\\U{cp:08x}"
    return "".join(esc(a) if a == b else f"{esc(a)}-{esc(b)}" for a, b in parts)


@functools.lru_cache()
def _pattern() -> "re.Pattern":
    """The CLIP pre-tokenization pattern (contractions, letter runs, single
    digits, runs of anything else but spaces) on stdlib ``re``, for the
    lower-cased text :func:`_clean_text` gives.  What ``regex.IGNORECASE``
    adds there is spelled out, as ``re.IGNORECASE`` would add other
    characters: ``'s`` also takes the long s (U+017F), which folds to s; and
    a character whose case mapping is a letter is left out of
    ``[^\\s\\p{L}\\p{N}]`` although it is no letter itself (U+0345, whose
    upper case is a Greek capital iota), so that no alternative takes it."""
    cat = unicodedata.category
    letter_cps, number_cps, cased_cps = [], [], []
    for cp in range(sys.maxunicode + 1):
        ch = chr(cp)
        c = cat(ch)[0]
        if c == "L":
            letter_cps.append(cp)
        elif c == "N":
            number_cps.append(cp)
        elif ch.lower() != ch or ch.upper() != ch:
            if any(len(v) == 1 and cat(v)[0] == "L" for v in (ch.lower(), ch.upper())):
                cased_cps.append(cp)
    letters, numbers = _ranges(letter_cps), _ranges(number_cps)
    return re.compile(
        "<\\|startoftext\\|>|<\\|endoftext\\|>|'[s\u017f]|'t|'re|'ve|'m|'ll|'d"
        f"|[{letters}]+|[{numbers}]|[^\\s{letters}{numbers}{_ranges(cased_cps)}]+")


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte -> unicode-char table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return set(zip(word[:-1], word[1:]))


def _clean_text(text: str) -> str:
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text.strip())
    return text.lower()


def default_bpe_path() -> str:
    env = os.environ.get("FOUNDDIFF_CLIP_BPE")
    if env:
        return env
    return os.path.expanduser("~/.cache/clip/bpe_simple_vocab_16e6.txt.gz")


class ClipTokenizer:
    """SimpleTokenizer-compatible BPE tokenizer.  ``merges``: an in-memory
    list of ``(first, second)`` pairs; else the merges file at ``bpe_path``
    (or :func:`default_bpe_path`), gzipped or not, in the OpenAI format (a
    version header, then one merge per line)."""

    def __init__(self, merges=None, bpe_path: str | None = None):
        if merges is None:
            path = bpe_path or default_bpe_path()
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"CLIP BPE merges not found at {path!r}. Download "
                    "bpe_simple_vocab_16e6.txt.gz (shipped with the openai/"
                    "clip package) and set FOUNDDIFF_CLIP_BPE or pass "
                    "bpe_path.")
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            # the stock file's merges are lines [1, 49152 - 256 - 2 + 1); a
            # shorter table ends early, and blank or malformed lines are dropped
            merges = [m for line in lines[1:49152 - 256 - 2 + 1]
                      if len(m := tuple(line.split())) == 2]
        merges = [tuple(m) for m in merges]
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab.extend([SOT_TOKEN, EOT_TOKEN])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {SOT_TOKEN: SOT_TOKEN, EOT_TOKEN: EOT_TOKEN}
        self.sot_id = self.encoder[SOT_TOKEN]
        self.eot_id = self.encoder[EOT_TOKEN]
        # max id + 1: a synthetic table may repeat a base token (49408 for the stock one)
        self.vocab_size = max(self.encoder.values()) + 1

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for token in _pattern().findall(_clean_text(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def tokenize(self, texts, context_length: int = 77, truncate: bool = False) -> np.ndarray:
        """``clip.tokenize``: [SOT] + BPE ids + [EOT], zero-padded to
        ``context_length``; int32 [len(texts), context_length]."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot_id] + self.encode(text) + [self.eot_id]
            if len(ids) > context_length:
                if not truncate:
                    raise RuntimeError(f"input {text!r} is too long for context length "
                                       f"{context_length}")
                ids = ids[:context_length]
                ids[-1] = self.eot_id
            out[i, :len(ids)] = ids
        return out


CT_PROMPTS = ("high dose CT image..", "low dose CT noisy image..")


def bootstrap_prompt_learner(token_embedding: np.ndarray, tokenizer: ClipTokenizer,
                             prompts: Sequence[str] = CT_PROMPTS, n_ctx: int = 16,
                             context_length: int = 77):
    """``(params, eot_indices, name_lens)`` of the reference's PromptLearner
    init (src/DACLIP.py:906-926): ``ctx [n_cls, n_ctx, width]``,
    ``token_prefix [n_cls, 1, width]`` and ``token_suffix [n_cls, 77 - 1 -
    n_ctx, width]`` read from the pretrained ``[vocab, width]`` table at the
    tokenized prompts, the EOT positions, and the reference's fixed name
    lengths (3, 3)."""
    prefix = " ".join(["X"] * n_ctx) + " "
    ids = tokenizer.tokenize([prefix + p for p in prompts], context_length)
    emb = np.asarray(token_embedding)[ids]
    params = {
        "ctx": emb[:, 1:1 + n_ctx].copy(),
        "token_prefix": emb[:, :1].copy(),
        "token_suffix": emb[:, 1 + n_ctx:].copy(),
    }
    eot_indices = tuple(int(i) for i in ids.argmax(axis=-1))
    return params, eot_indices, (3, 3)
