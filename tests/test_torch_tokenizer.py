"""The port's BPE tokenizer (``founddiff_tpu_torch/models/tokenizer.py``)
against the JAX package's, which runs on the ``regex`` package, on the
fixture vocabulary ``tests/fixtures/bpe_tiny_vocab.txt.gz``:

- ids equal over a corpus of accented and CJK letters, the numbers ``²``,
  ``½``, ``Ⅻ`` and ``٣``, emoji, HTML entities, the contractions (``''s``
  among them), runs of whitespace and the characters whose case mapping is
  a letter;
- the pre-tokenization itself over every assigned code point of Python's
  Unicode database, between letters, digits and a contraction;
- ``decode`` round trip; ``tokenize`` framing, truncation and its error;
- ``bootstrap_prompt_learner`` arrays equal to JAX's;
- the module imports and encodes with ``regex`` unimportable.
"""

import os
import subprocess
import sys
import unicodedata

import numpy as np
import pytest

from founddiff_tpu.models import tokenizer as jtok
from founddiff_tpu_torch.models import tokenizer as ttok

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "bpe_tiny_vocab.txt.gz")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = [
    "high dose CT image..", "low dose CT noisy image..",
    "Ça résume l'été à Zürich — naïve façade, ĳssel Ǆemal",
    "東京の天気は晴れ、気温は２５度です。 서울 北京",
    "x² + ½ = Ⅻ, ٣ and ³⁄₄ ① ⑳ ₀₁₂ ௰ ፲ 𝟘𝟙 ↉",
    "emoji 😀🎉👍🏽 🇩🇪 ok❤️",
    "&amp;lt;b&amp;gt; &quot;quoted&quot; &#39;s &eacute; &nbsp;x",
    "it's they're we've I'm you'll he'd ''s 'S 'LL O'Neil rock'n'roll",
    "  runs\t\tof \n\n whitespace 　 and nbsp   ",
    "a1b2 ... x dose-dose--x 3.14159 1,000,000",
    "ſtraße 's 'ſ ͅ xͅy ́e ǅungla ǈ ǋ ᾈ İstanbul ı K ﬁﬂ ªº ᵃᵇ ʰ ’s ‘t",
    "<|startoftext|> inside <|endoftext|> text",
]


@pytest.fixture(scope="module")
def pair():
    return ttok.ClipTokenizer(bpe_path=FIXTURE), jtok.ClipTokenizer(bpe_path=FIXTURE)


@pytest.mark.parametrize("i", range(len(CORPUS)))
def test_ids_equal_jax(pair, i):
    port, ref = pair
    assert port.encode(CORPUS[i]) == ref.encode(CORPUS[i])
    np.testing.assert_array_equal(port.tokenize(CORPUS[i], truncate=True),
                                  ref.tokenize(CORPUS[i], truncate=True))


def test_pattern_over_every_code_point():
    """Each assigned code point between a letter, a digit and a contraction:
    the same pieces from both patterns.  The four control characters that
    ``re``'s ``\\s`` takes and the ``regex`` package's does not never reach
    the pattern (``_clean_text`` has made them spaces)."""
    pat = ttok._pattern()
    bad = []
    for cp in range(sys.maxunicode + 1):
        ch = chr(cp)
        if unicodedata.category(ch) in ("Cn", "Cs") or 0x1C <= cp <= 0x1F:
            continue
        text = ("a" + ch + "1'" + ch + "s " + ch + ch).lower()
        if pat.findall(text) != jtok._PAT.findall(text):
            bad.append(hex(cp))
    assert not bad, bad[:20]


def test_decode_round_trip(pair):
    port, ref = pair
    text = "high dose ct image.. Zürich 東京"
    assert port.decode(port.encode(text)) == ref.decode(ref.encode(text))
    assert port.decode(port.encode("high dose ct image..")).strip() == "high dose ct image .."


def test_tokenize_framing_and_truncation(pair):
    port, ref = pair
    ids = port.tokenize(["hi dose", "hi"], context_length=10)
    assert ids.dtype == np.int32 and ids.shape == (2, 10)
    np.testing.assert_array_equal(ids, ref.tokenize(["hi dose", "hi"], context_length=10))
    assert ids[0, 0] == port.sot_id and ids[0, ids[0].argmax()] == port.eot_id
    with pytest.raises(RuntimeError, match="too long for context length 8"):
        port.tokenize(["hi " * 30], context_length=8)
    trunc = port.tokenize(["hi " * 30], context_length=8, truncate=True)
    np.testing.assert_array_equal(trunc, ref.tokenize(["hi " * 30], context_length=8,
                                                      truncate=True))
    assert trunc[0, -1] == port.eot_id
    assert port.vocab_size == ref.vocab_size == 533


def test_bootstrap_prompt_learner(pair):
    port, ref = pair
    table = np.random.default_rng(0).standard_normal((port.vocab_size, 16)).astype(np.float32)
    got, eot, lens = ttok.bootstrap_prompt_learner(table, port)
    want, jeot, jlens = jtok.bootstrap_prompt_learner(table, ref)
    assert (eot, lens) == (jeot, jlens) and eot == (25, 28)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_bpe_path_sources(monkeypatch, tmp_path):
    monkeypatch.setenv("FOUNDDIFF_CLIP_BPE", FIXTURE)
    assert ttok.default_bpe_path() == FIXTURE
    assert ttok.ClipTokenizer().encode(CORPUS[0]) == jtok.ClipTokenizer().encode(CORPUS[0])
    monkeypatch.setenv("FOUNDDIFF_CLIP_BPE", str(tmp_path / "absent.txt.gz"))
    with pytest.raises(FileNotFoundError, match="CLIP BPE merges not found"):
        ttok.ClipTokenizer()
    merges = [("h", "i"), ("hi", "</w>")]
    assert ttok.ClipTokenizer(merges=merges).encode("hi hi") == \
        jtok.ClipTokenizer(merges=merges).encode("hi hi")


def test_imports_without_regex():
    code = ("import sys; sys.modules['regex'] = None\n"
            "from founddiff_tpu_torch.models.tokenizer import ClipTokenizer\n"
            f"print(ClipTokenizer(bpe_path={FIXTURE!r}).encode('x² Ⅻ hi dose'))\n"
            "assert 'jax' not in sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == str(jtok.ClipTokenizer(bpe_path=FIXTURE).encode("x² Ⅻ hi dose"))
