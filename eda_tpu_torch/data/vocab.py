"""Linguistic vocabularies for the text decoupler.

The port's own copy of ``eda_tpu/data/vocab.py`` and of the word lists it
reads (``meta/``); host code, unchanged.

The reference's decoupler is a spaCy dependency parse plus large heuristic
word lists (``sng_parser/backends/spacy_parser.py``, ``sng_parser/_data``).
This environment has no spaCy, so the rebuild's decoupler
(``eda_tpu_torch.data.decouple``) is a deterministic rule-based chunker driven by
the vocabularies below:

* object nouns come from the ScanNet v2 label TSV (public dataset metadata,
  ``eda_tpu_torch/data/meta/scannetv2-labels.combined.tsv``) plus common household
  synonyms — the same information source as the reference's class vocab
  (``src/scannet_classes.py``, ``data/scannet_utils.py:20-32``);
* relation phrases cover the view-dependent and topological relations the
  reference enumerates (``src/scannet_classes.py:851-912``);
* attributes are everyday colors/sizes/shapes/materials/ordinals.
"""

from __future__ import annotations

import csv
import functools
import os
from typing import Dict, FrozenSet, List, Set

_META_DIR = os.path.join(os.path.dirname(__file__), "meta")
LABELS_TSV = os.path.join(_META_DIR, "scannetv2-labels.combined.tsv")

def _load_wordlist(name: str) -> FrozenSet[str]:
    """A word list from the reference's sng_parser/_data (public vocabulary
    data, ported verbatim like the typo tables; database.py:18-41). Missing
    files raise: a silently empty list would quietly change every parse."""
    path = os.path.join(_META_DIR, name)
    with open(path) as f:
        return frozenset(line.strip() for line in f if line.strip())


# the reference's 402-entry scene-noun list (chunks headed by these become
# Scene nodes, excluded from other/auxi maps) + our structural extras
_SCENE_NOUN_FILE: FrozenSet[str] = _load_wordlist("scene-nouns.txt")
_SCENE_EXTRAS: FrozenSet[str] = frozenset(
    """room corner center centre middle side end area entrance hallway kitchen
    bathroom bedroom office wall walls floor ceiling doorway alcove nook space
    edge top bottom front back left right row bunch set pair group scene
    """.split()
)
SCENE_NOUNS: FrozenSet[str] = _SCENE_NOUN_FILE | _SCENE_EXTRAS

# Structural extras that are NOT entities to the reference (absent from its
# scene-noun file, so spaCy noun chunks headed by them are filtered out of
# ``filter_entity_chunks``, spacy_parser.py:130-163): the reference's
# relation-subject head walks pass straight THROUGH them ("the pillow from
# the left on the bed" — *on*'s chain runs left -> from -> pillow). The
# rule-based subject/landmark resolution must treat chunks headed by these
# as transparent the same way. wall/floor are excluded: they ARE reference
# entities (485-class Object nouns), just never the main one.
TRANSPARENT_SCENE_WORDS: FrozenSet[str] = (
    _SCENE_EXTRAS - _SCENE_NOUN_FILE - frozenset(("wall", "walls", "floor"))
)

# wall/floor are valid Object chunks but never the main entity
# (spacy_parser.py:175-176).
NON_MAIN_OBJECTS: FrozenSet[str] = frozenset({"wall", "floor"})

PRONOUNS: FrozenSet[str] = frozenset(
    "it its itself they them this that these those one which".split()
)

DETERMINERS: FrozenSet[str] = frozenset(
    "a an the this that these those some any each every all both no its your".split()
)

COPULAS: FrozenSet[str] = frozenset(
    """is are was were be being been sits sit stands stand located situated
    placed positioned hangs hanging hung lies lying facing faces looks look
    appears seems has have""".split()
)

CONJUNCTIONS: FrozenSet[str] = frozenset("and or but also with".split())

ATTRIBUTES: FrozenSet[str] = frozenset(
    """black white red blue green yellow brown grey gray orange purple pink
    beige tan cream maroon navy teal turquoise golden gold silver dark light
    darker lighter colored colorful multicolored
    big large larger largest small smaller smallest tiny huge tall taller
    tallest short shorter shortest long longer longest wide wider widest
    narrow thick thin low lower lowest high higher highest mini
    round square rectangular circular oval curved flat l-shaped u-shaped
    straight angled slanted
    wooden wood metal metallic plastic leather glass fabric cloth marble
    granite ceramic steel brick stone concrete cardboard paper padded
    cushioned upholstered tiled wicker
    first second third fourth fifth last final leftmost rightmost middle
    closest nearest farthest furthest upper lower top bottom
    open closed empty full new old modern clean dirty broken folded rolled
    striped checkered patterned plain shiny matte fuzzy soft hard comfy
    comfortable messy neat organized stacked single double grooved ridged
    lit unlit bright
    """.split()
)

# Multi-word relation phrases, longest-first for greedy matching. Covers the
# reference relation vocabulary (scannet_classes.py:851-912) plus common
# ScanRefer phrasings.
RELATION_PHRASES: List[str] = sorted(
    [
        "on the left side of", "on the right side of", "on the back of",
        "in the center of", "in the middle of", "to the left of",
        "to the right of", "on the left of", "on the right of",
        "on the other side of", "in front of", "on top of", "far away from",
        "farthest from", "furthest from", "far from", "close to", "closer to",
        "closest to", "nearer to", "next to",
        "near to", "adjacent to", "beside", "between",
        "behind", "above", "below", "beneath", "under", "underneath", "over",
        "across from", "opposite of", "opposite", "against", "surrounding",
        "supporting", "supported by", "attached to", "mounted on", "hanging on",
        "hanging over", "lying on", "sitting on", "standing on", "leaning on",
        "leaning against", "resting on", "on", "in", "inside", "within", "at",
        "by", "near", "underneath of", "left of", "right of",
    ],
    key=lambda p: -len(p.split()),
)

EXTRA_OBJECT_NOUNS: FrozenSet[str] = frozenset(
    """object thing item furniture appliance device fixture container unit
    shelf shelves couch sofa tv television monitor screen computer laptop
    bin can trashcan trash recycling photo picture frame painting poster
    cup mug bottle plant pot vase book books bag backpack purse box boxes
    machine printer copier whiteboard blackboard board clock mirror window
    door doors cabinet cabinets drawer drawers stand rack holder hook
    light lamp lights pillow cushion blanket sheet towel rug mat carpet
    curtain curtains blinds heater radiator vent fan outlet switch sign
    ladder stool bench seat chair chairs armchair table tables desk desks
    bed beds nightstand dresser wardrobe closet bookshelf bookcase fridge
    refrigerator freezer microwave oven stove sink toilet urinal bathtub
    tub shower basket hamper suitcase luggage guitar piano keyboard mouse
    phone telephone speaker
    """.split()
)


def _candidates(word: str):
    """Lowercase plus singular-ized candidates for vocab lookup."""
    w = word.lower()
    yield w
    if len(w) > 3 and w.endswith("ies"):
        yield w[:-3] + "y"  # cubbies -> cubby
    if len(w) > 3 and w.endswith("es"):
        yield w[:-2]  # couches -> couch, boxes -> box
    if len(w) > 3 and w.endswith("s") and not w.endswith("ss"):
        yield w[:-1]  # chairs -> chair


def _norm(word: str) -> str:
    """Lowercase and strip a trailing plural 's' for vocab lookup."""
    w = word.lower()
    if len(w) > 3 and w.endswith("s") and not w.endswith("ss"):
        return w[:-1]
    return w


def lemma(word: str) -> str:
    """Best-effort noun lemma: the first singularization that is a known
    vocabulary noun, else the lowercase word. Approximates spaCy's
    ``token.lemma_`` for the ScanNet noun vocabulary (the reference's
    ``lemma_head``, spacy_parser.py:91)."""
    for cand in _candidates(word):
        if cand in object_nouns():
            return cand
    return _norm(word)


@functools.lru_cache(maxsize=1)
def object_nouns() -> FrozenSet[str]:
    """Single-word object nouns: ScanNet categories + common extras + the
    reference's object-nouns list (database.is_object_noun is OR'd into the
    Object check, spacy_parser.py:135-137)."""
    words: Set[str] = set(EXTRA_OBJECT_NOUNS) | set(
        _load_wordlist("object-nouns.txt")
    )
    for phrase in object_phrases():
        if " " not in phrase:
            words.add(phrase)
    # singular forms of everything too
    words |= {_norm(w) for w in set(words)}
    return frozenset(words)


@functools.lru_cache(maxsize=1)
def object_phrases() -> FrozenSet[str]:
    """All ScanNet category names (may be multi-word, e.g. 'trash can')."""
    phrases: Set[str] = set()
    if os.path.exists(LABELS_TSV):
        with open(LABELS_TSV, newline="") as f:
            for row in csv.DictReader(f, delimiter="\t"):
                for key in ("raw_category", "category", "nyuClass", "nyu40class"):
                    name = (row.get(key) or "").strip().lower()
                    if name and name not in ("otherprop", "otherstructure", "otherfurniture"):
                        phrases.add(name)
    return frozenset(phrases)


@functools.lru_cache(maxsize=1)
def multiword_objects() -> Dict[int, FrozenSet[str]]:
    """Multi-word object phrases grouped by word count (for greedy matching)."""
    by_len: Dict[int, Set[str]] = {}
    for phrase in object_phrases():
        n = len(phrase.split())
        if n > 1:
            by_len.setdefault(n, set()).add(phrase)
    return {n: frozenset(s) for n, s in sorted(by_len.items(), reverse=True)}


def is_object_noun(word: str) -> bool:
    nouns = object_nouns()
    return any(c in nouns for c in _candidates(word))


def is_scene_noun(word: str) -> bool:
    return any(c in SCENE_NOUNS for c in _candidates(word))


# Canonical SR3D relation aliases (reference src/scannet_classes.py:880-912)
# — vocabulary constants like the typo tables, keyed longest-first by
# _find_rel (joint_det_dataset.py:1054-1067).
REL_ALIASES: Dict[str, str] = {
    "above": "above",
    "behind": "behind",
    "below": "below",
    "beneath": "below",
    "beside": "near",
    "between": "between",
    "close to": "near",
    "closer to": "near",
    "far away from": "far from",
    "far from": "far from",
    "farthest from": "far from",
    "in front of": "in front of",
    "in the center of": "between",
    "in the middle of": "between",
    "lying on": "on",
    "near": "near",
    "next to": "near",
    "on": "on",
    "on the back of": "behind",
    "on the left of": "on the left of",
    "on the left side of": "on the left of",
    "on the right of": "on the right of",
    "on the right side of": "on the right of",
    "on top": "on",
    "on top of": "on",
    "over": "above",
    "supporting": "below",
    "to the left of": "on the left of",
    "to the right of": "on the right of",
    "under": "below",
    "underneath": "below",
}

# Relations whose truth depends on the viewpoint — SR3D skips the rotation
# augmentation for them (reference src/scannet_classes.py:851-861).
VIEW_DEP_RELS: List[str] = [
    "behind",
    "in front of",
    "on the back of",
    "on the left of",
    "on the left side of",
    "on the right of",
    "on the right side of",
    "to the left of",
    "to the right of",
]


def find_rel(utterance: str) -> str:
    """Longest-alias relation phrase in the utterance -> canonical name,
    'none' if absent (reference _find_rel, joint_det_dataset.py:1054-1067)."""
    padded = " " + utterance.replace(",", " ,") + " "
    for alias in sorted(REL_ALIASES, key=len, reverse=True):
        if f" {alias} " in padded:
            return REL_ALIASES[alias]
    return "none"
