"""Host-side text tokenizers for LUT conditioners
(a copy of ``audiocraft_tpu/cond/tokenizers.py``, which the port may not
import; the two must give the same ids, and ``tests/test_torch_magnet.py``
holds them to that).

Mirrors the reference audiocraft ``modules/conditioners.py:239-342``:
* ``hash_trick`` — sha256-based word hashing, byte-identical to the reference
  (``utils/utils.py:193-203``).
* ``WhiteSpaceTokenizer`` — number-to-words, stopword and punctuation removal,
  lemmatization, then per-word hash.  The reference runs spaCy
  (``en_core_web_sm``), which is not a dependency here, so this module ships
  a self-contained approximation of the spaCy pipeline pieces the reference
  actually uses: contraction splitting (``didn't`` -> ``did`` + ``n't``,
  ``he's`` -> ``he`` + ``'s``, matching the spaCy English tokenizer
  exceptions), the spaCy English stopword list (incl. the clitic forms), and
  a rule-based lemmatizer (:func:`lemmatize`): irregular-form lookup + the
  spaCy English suffix rules (noun ``-s/-ies/-ses/-ves``, verb
  ``-ing/-ed/-ies``, adj ``-er/-est``) gated by a compact embedded base-form
  index + orthographic guards standing in for spaCy's vocabulary-index
  check, without POS disambiguation.  Mid-prompt capitalized words are
  treated as proper nouns (identity lemma, case kept, as en_core_web_sm
  does for PROPN); the sentence-initial token is lowercased and lemmatized.

  The residual against spaCy is POS-ambiguous forms where only a tagger can
  pick the reading (e.g. "left" leave/left, "saw" see/saw, noun-reading
  "-ing" forms) and capitalized non-proper nouns mid-prompt.  This only
  affects which LUT bin a word hashes to for models trained from scratch;
  published checkpoints condition via T5, not the LUT tokenizer.  Pass
  ``lemma=False, stopwords=False`` for a deterministic pipeline on both
  sides.
* ``NoopTokenizer`` — one hash per whole string.
"""

from __future__ import annotations

import hashlib
import re
import typing as tp

import numpy as np

PUNCTUATION = "?:!.,;"

# english stopwords (spaCy's default list, abbreviated to the high-frequency
# core; used only when `stopwords=True`)
_STOPWORDS = frozenset("""a about above after again all am an and any are as at
be because been before being below between both but by could did do does doing
down during each few for from further had has have having he her here hers
herself him himself his how i if in into is it its itself just me more most my
myself no nor not now of off on once only or other our ours ourselves out over
own same she should so some such than that the their theirs them themselves
then there these they this those through to too under until up very was we
were what when where which while who whom why will with you your yours
yourself yourselves n't 's 'm 're 've 'll 'd""".split())

# ---------------------------------------------------------------------------
# Rule lemmatizer (spaCy en_core_web_sm approximation; see module docstring)
# ---------------------------------------------------------------------------

# Compact base-form index standing in for spaCy's vocabulary check: suffix
# rules only fire when the candidate stem is a listed base form (or passes
# an orthographic guard).  Skewed toward music-description vocabulary.
_VOCAB = frozenset("""
play make take give use drive ride fade groove dance glide shine move come
create vibrate resonate modulate improvise rise evolve weave breathe build
drop strum drum hum pluck swell soar float drift pulse swirl ring sing loop
layer blend mix echo repeat flow roll slide bounce shimmer sparkle thump
knock clap snap stomp chant croon wail riff jam solo vamp syncopate accent
mute distort filter sweep pan delay compress sustain release attack decay
swing string bring spring wave phrase chase race pace phase blaze surge
melody harmony rhythm beat bass guitar piano violin cello flute horn
trumpet sax synth pad lead chord note key scale tempo song track tune sound
tone texture timbre vibe mood atmosphere intro outro verse chorus bridge
hook breakdown sample kick snare hat cymbal tom conga bongo shaker bell
chime voice vocal choir organ accordion banjo mandolin harp sitar tabla
class bass leaf hero wolf knife life half wave shoe groove drone stab arp
slow fast soft loud deep bright dark warm cool light smooth low high rich
full clean sharp flat strong quiet calm heavy thick thin long short big
small mellow gentle happy sad funky groovy dreamy airy breezy catchy punchy
crisp lush sparse dense raw pure wide close early late nice large simple
free hard sweet cold hot young old new fresh clear fine great good bad
record produce master arrange compose perform practice rehearse strike
speaker stage studio festival concert band artist singer player drummer
guitarist pianist bassist producer composer listener crowd audience
""".split())

# Irregular surface form -> lemma (spaCy exception-table subset; only forms
# realistic in music prompts, plus the clitic lemmas used when
# ``stopwords=False`` keeps them).
_IRREGULAR = {
    # verbs
    'made': 'make', 'sang': 'sing', 'sung': 'sing', 'drove': 'drive',
    'driven': 'drive', 'rode': 'ride', 'ridden': 'ride', 'wrote': 'write',
    'written': 'write', 'built': 'build', 'kept': 'keep', 'felt': 'feel',
    'held': 'hold', 'brought': 'bring', 'thought': 'think',
    'caught': 'catch', 'taught': 'teach', 'began': 'begin',
    'begun': 'begin', 'broke': 'break', 'broken': 'break',
    'chose': 'choose', 'chosen': 'choose', 'came': 'come', 'gave': 'give',
    'given': 'give', 'went': 'go', 'gone': 'go', 'goes': 'go',
    'grew': 'grow', 'grown': 'grow', 'heard': 'hear', 'knew': 'know',
    'known': 'know', 'led': 'lead', 'lost': 'lose', 'met': 'meet',
    'paid': 'pay', 'ran': 'run', 'said': 'say', 'sat': 'sit',
    'sold': 'sell', 'sent': 'send', 'shook': 'shake', 'shaken': 'shake',
    'shone': 'shine', 'showed': 'show', 'shown': 'show', 'slept': 'sleep',
    'spoke': 'speak', 'spoken': 'speak', 'spent': 'spend',
    'stood': 'stand', 'struck': 'strike', 'swung': 'swing',
    'took': 'take', 'taken': 'take', 'told': 'tell', 'threw': 'throw',
    'thrown': 'throw', 'woke': 'wake', 'woken': 'wake', 'wore': 'wear',
    'worn': 'wear', 'won': 'win', 'blew': 'blow', 'blown': 'blow',
    'flew': 'fly', 'flown': 'fly', 'fell': 'fall', 'fallen': 'fall',
    'found': 'find', 'got': 'get', 'gotten': 'get', 'lit': 'light',
    'meant': 'mean', 'rose': 'rise', 'risen': 'rise',
    # nouns
    'men': 'man', 'women': 'woman', 'children': 'child', 'feet': 'foot',
    'teeth': 'tooth', 'mice': 'mouse', 'leaves': 'leaf', 'lives': 'life',
    'wolves': 'wolf', 'knives': 'knife', 'halves': 'half',
    # clitics (spaCy lemma when not stopword-removed)
    "n't": 'not', "'m": 'be', "'re": 'be', "'ve": 'have', "'ll": 'will',
    "'d": 'would',
    # forms spaCy leaves alone that the rules would mangle
    'blues': 'blues',
}

# "-ing" surface forms spaCy lemmatizes to themselves in the noun reading
# that dominates prompts (morning walk, wedding band, ...).
_ING_KEEP = frozenset("""morning evening ceiling feeling wedding building
nothing something everything anything darling""".split())

_VOWELS = set('aeiouy')


def _has_vowel(s: str) -> bool:
    return any(c in _VOWELS for c in s)


def lemmatize(word: str, sent_initial: bool = False) -> str:
    """Rule-based English lemmatizer approximating spaCy en_core_web_sm
    (reference pipeline: conditioners.py:285-302 ``t.lemma_``).  No POS
    tagger: mid-prompt capitalized words are treated as PROPN (identity,
    case kept); everything else is lowercased and sent through the
    exception table + suffix rules, vocabulary-gated by ``_VOCAB``."""
    if not word or not word[0].isalpha():
        if word.lower() in _IRREGULAR:  # clitics start with "'"
            return _IRREGULAR[word.lower()]
        return word
    if word[0].isupper() and (word.isupper() or not sent_initial):
        return word  # PROPN / acronym: identity lemma, case kept
    lw = word.lower()
    if lw in _IRREGULAR:
        return _IRREGULAR[lw]
    if lw in _VOCAB or lw in _ING_KEEP:
        return lw
    # --- verb -ing -------------------------------------------------------
    if lw.endswith('ing') and len(lw) >= 5:
        stem = lw[:-3]
        if stem in _VOCAB:
            return stem
        if stem + 'e' in _VOCAB:
            return stem + 'e'
        if len(stem) >= 3 and stem[-1] == stem[-2] and stem[-1] in 'bdgmnprt':
            und = stem[:-1]
            return und if (und in _VOCAB or _has_vowel(und)) else lw
        return stem if _has_vowel(stem) else lw
    # --- verb/adj -ed ----------------------------------------------------
    if lw.endswith('ied') and len(lw) >= 5:
        return lw[:-3] + 'y'
    if lw.endswith('ed') and len(lw) >= 4:
        stem = lw[:-2]
        if stem in _VOCAB:
            return stem
        if stem + 'e' in _VOCAB:
            return stem + 'e'
        if len(stem) >= 3 and stem[-1] == stem[-2] and stem[-1] in 'bdgmnprt':
            und = stem[:-1]
            return und if (und in _VOCAB or _has_vowel(und)) else lw
        return stem if _has_vowel(stem) else lw
    # --- adj -er / -est (vocabulary-gated only; "hammer" must survive) ----
    for suf in ('iest', 'ier'):
        if lw.endswith(suf) and len(lw) >= len(suf) + 2:
            cand = lw[:-len(suf)] + 'y'
            if cand in _VOCAB:
                return cand
    for suf in ('est', 'er'):
        if lw.endswith(suf) and len(lw) >= len(suf) + 2:
            stem = lw[:-len(suf)]
            if stem in _VOCAB:
                return stem
            if stem + 'e' in _VOCAB:
                return stem + 'e'
    # --- noun plurals ------------------------------------------------------
    if lw.endswith('ies') and len(lw) >= 5:
        return lw[:-3] + 'y'
    if lw.endswith(('ches', 'shes', 'xes', 'zes')) and len(lw) >= 5:
        return lw[:-2]
    for strip2 in ('ses', 'oes', 'ves'):  # vocabulary-gated ("phrases",
        if lw.endswith(strip2):           # "shoes", "waves" fall through)
            cand = (lw[:-3] + 'f') if strip2 == 'ves' else lw[:-2]
            if cand in _VOCAB:
                return cand
    if lw.endswith('s') and not lw.endswith(('ss', 'us', 'is')) \
            and len(lw) >= 4:
        stem = lw[:-1]
        return stem if _has_vowel(stem) else lw
    return lw

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]


def num2words(n: int) -> str:
    """Minimal English number verbalization (num2words-compatible for the
    common range)."""
    if n < 0:
        return "minus " + num2words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        t, r = divmod(n, 10)
        return _TENS[t] + (f"-{_ONES[r]}" if r else "")
    if n < 1000:
        h, r = divmod(n, 100)
        return f"{_ONES[h]} hundred" + (f" and {num2words(r)}" if r else "")
    for scale, name in ((10 ** 9, "billion"), (10 ** 6, "million"),
                        (10 ** 3, "thousand")):
        if n >= scale:
            head, r = divmod(n, scale)
            out = f"{num2words(head)} {name}"
            if r:
                out += f" {num2words(r)}" if r >= 100 else f" and {num2words(r)}"
            return out
    return str(n)


def hash_trick(word: str, vocab_size: int) -> int:
    h = int(hashlib.sha256(word.encode("utf-8")).hexdigest(), 16)
    return h % vocab_size


def length_to_mask(lengths: np.ndarray, max_len: tp.Optional[int] = None) -> np.ndarray:
    assert lengths.ndim == 1
    final_length = int(lengths.max()) if not max_len else max_len
    final_length = max(final_length, 1)
    return (np.arange(final_length)[None, :] < lengths[:, None])


# spaCy-English-style token stream: contraction clitics split off their
# host ("didn't" -> "did"+"n't", "he's" -> "he"+"'s"), words, and single
# non-space symbols.  Ordered alternation + the lookahead makes the host
# word stop before "n't".
_TOKEN_RE = re.compile(
    r"\w+(?=n't\b)|n't\b|'(?:s|m|re|ve|ll|d)\b|\w+|[^\w\s]", re.IGNORECASE)


def _tokenize(text: str) -> tp.List[str]:
    toks: tp.List[str] = []
    for t in _TOKEN_RE.findall(text):
        if t.lower() == 'cannot':  # spaCy exception: "cannot" -> can + not
            toks += [t[:3], t[3:]]
        else:
            toks.append(t)
    return toks


class WhiteSpaceTokenizer:
    def __init__(self, n_bins: int, pad_idx: int = 0, lemma: bool = True,
                 stopwords: bool = True):
        self.n_bins = n_bins
        self.pad_idx = pad_idx
        self.lemma = lemma
        self.stopwords = stopwords

    def __call__(self, texts: tp.List[tp.Optional[str]]
                 ) -> tp.Tuple[np.ndarray, np.ndarray]:
        output, lengths = [], []
        for text in texts:
            if text is None:
                output.append([self.pad_idx])
                lengths.append(0)
                continue
            text = re.sub(r"(\d+)", lambda m: num2words(int(m.group(0))), text)
            toks = _tokenize(text)
            # (surface, lemma) pairs: filtering matches the reference order
            # (stopwords, then punctuation, then lemma_ attribute read)
            pairs = [(w, lemmatize(w, sent_initial=(i == 0)))
                     for i, w in enumerate(toks)]
            if self.stopwords:
                pairs = [p for p in pairs if p[0].lower() not in _STOPWORDS]
            pairs = [p for p in pairs if p[0] not in PUNCTUATION]
            words = [(lem if self.lemma else w) for w, lem in pairs]
            lengths.append(len(words))
            output.append([hash_trick(w, self.n_bins) for w in words])
        mask = length_to_mask(np.asarray(lengths)).astype(np.int32)
        T = mask.shape[1]
        padded = np.full((len(output), T), self.pad_idx, np.int32)
        for i, toks in enumerate(output):
            padded[i, :len(toks)] = toks[:T]
        return padded, mask


class NoopTokenizer:
    def __init__(self, n_bins: int, pad_idx: int = 0):
        self.n_bins = n_bins
        self.pad_idx = pad_idx

    def __call__(self, texts: tp.List[tp.Optional[str]]
                 ) -> tp.Tuple[np.ndarray, np.ndarray]:
        output, lengths = [], []
        for text in texts:
            if text is None:
                output.append(self.pad_idx)
                lengths.append(0)
            else:
                output.append(hash_trick(text, self.n_bins))
                lengths.append(1)
        tokens = np.asarray(output, np.int64)[:, None]
        mask = length_to_mask(np.asarray(lengths)).astype(np.int32)
        return tokens, mask
