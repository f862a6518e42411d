"""Text decoupling: split an utterance into main / attribute / pronoun /
relation / other-object character spans.

The port's own copy of ``eda_tpu/data/decouple.py``; host code, unchanged.

This is EDA's first contribution: every utterance is decomposed into five
semantic components which the dense alignment losses supervise separately
(reference ``sng_parser/backends/spacy_parser.py`` driven from
``src/joint_det_dataset.py:1310-1399``).

The reference implementation needs spaCy's dependency parser plus ~700 lines
of heuristics. This rebuild uses a deterministic rule-based chunker over the
vocabularies in ``eda_tpu_torch.data.vocab`` — no model download, no native
dependency, identical output *shape* (character spans consumed by
``get_positive_map``-style token alignment). The grammar of ScanRefer/SR3D/
NR3D utterances is narrow ("the brown chair. it is next to the table."), which
is what makes the rule-based approach viable.

Output mirrors the reference node schema (``spacy_parser.py:325-447``):
node 0 is the main entity carrying target/mod/pron/rel char spans; other
Object nodes carry their own target spans; ``auxi_entity`` is the first
non-main Object node (``joint_det_dataset.py:1393-1399``).

Relation attachment mirrors the reference's per-entity dependency walk
(``spacy_parser.py:221-300`` + edge filter at :436-447): each relation
phrase is resolved to a clause subject (the nearest preceding entity chunk,
with conjunction groups inheriting the prior relation's subject and
comma-separated trailing phrases attaching to the sentence subject — the
rule-based analog of walking ``token.head`` chains to ROOT/nsubj), and only
relations whose subject resolves to node 0 reach ``main.rel_char_span``,
exactly like the reference's ``edge['obj_idx'] == 0`` filter. Relations
whose backward walk lands on another entity first (``"hanging on the
window above the desk"`` — ``above`` attaches to *window*) belong to that
entity's edge, again like the spaCy head chain. The full edge list
(subject, relation span, landmark) is exposed as ``ParseResult.edges``,
the analog of the reference's ``graph_edge`` return.

Known deviations (documented, MEASURED benign for the alignment losses):
* relation WORDS are vocabulary-matched phrases (``vocab.RELATION_PHRASES``)
  rather than the dependency-path tokens of ``__find_rel_by_root``
  (:513-559) — the reference's path words are the same prepositions plus
  occasional verbs its VBN/VBZ/VBG filter already strips;
* the subject walk is positional (tokens backward) rather than a true
  dependency-head chain, so clause structure the walk cannot see (e.g. a
  relative clause whose verb re-attaches high: "the chair you see when
  facing the desk") resolves to the nearest entity instead of the spaCy
  head;
* relation phrases whose subject is node 0 but whose landmark is not a
  parsed entity ("the monitor on the left" — *left* is an attribute word)
  KEEP their rel span on the main node with ``landmark_id == -1``; the
  reference only emits rel spans through entity-to-entity edges
  (:221-300 iterates landmark entities), so it silently drops these — the
  spatial phrase still carries grounding signal, so dropping it would
  weaken ``rel_positive_map`` supervision for no parity gain;
* predicate attributes are found by [entity|pronoun] COPULA ADJ* patterns
  instead of dependency arcs (the 1200-utterance template corpus in
  ``tests/test_decouple_corpus.py`` asserts the predicate templates
  span-exactly).
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple

from eda_tpu_torch.data import vocab

Span = Tuple[int, int]

_TOKEN_RE = re.compile(r"[A-Za-z0-9'-]+|[^\sA-Za-z0-9]")


@dataclasses.dataclass
class Node:
    """One parsed entity (reference node dict, spacy_parser.py:426-447)."""

    node_id: int
    node_type: str  # Object | Scene | Pron
    target_char_span: List[Span] = dataclasses.field(default_factory=list)
    mod_char_span: List[Span] = dataclasses.field(default_factory=list)
    pron_char_span: List[Span] = dataclasses.field(default_factory=list)
    rel_char_span: List[Span] = dataclasses.field(default_factory=list)
    # lemmatized head noun phrase ('trash can'), the reference's lemma_head
    # (spacy_parser.py:91,116) — keys the 485-vocab lookup for auxi boxes
    lemma_head: str = ""


@dataclasses.dataclass
class Edge:
    """One relation edge (reference ``graph_edge`` entry, spacy_parser.py:238-247).

    ``subject_id`` is the node the relation describes (the reference's
    ``obj_idx`` — the clause subject); ``landmark_id`` the node it points at
    (the reference's ``sub_idx``), -1 when the relation has no entity after
    it ("the chair is in the corner" with unrecognized tail).
    """

    subject_id: int
    landmark_id: int
    rel_char_span: List[Span] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ParseResult:
    nodes: List[Node]
    relations: List[Span]
    edges: List[Edge] = dataclasses.field(default_factory=list)

    @property
    def main(self) -> Optional[Node]:
        return self.nodes[0] if self.nodes and self.nodes[0].node_id == 0 else None

    @property
    def auxi_entity(self) -> Optional[Node]:
        for node in self.nodes:
            if node.node_id != 0 and node.node_type == "Object":
                return node
        return None


@dataclasses.dataclass
class _Tok:
    text: str
    lower: str
    start: int
    end: int
    kind: str = "OTHER"  # DET NUM ADJ PRON NOUN_OBJ NOUN_SCENE REL COP CONJ PUNCT OTHER
    rel_group: int = -1  # tokens of one relation phrase share a group id


def _tokenize(text: str) -> List[_Tok]:
    return [
        _Tok(m.group(), m.group().lower(), m.start(), m.end())
        for m in _TOKEN_RE.finditer(text)
    ]


_NUM_WORDS = frozenset(
    "one two three four five six seven eight nine ten eleven twelve".split()
)

_SPATIAL_SUPERLATIVES = frozenset("nearest closest farthest furthest".split())


def _classify(toks: List[_Tok]) -> None:
    """Tag tokens; relation phrases get greedy longest-match priority."""
    n = len(toks)
    # relation phrases first (multi-word, longest wins)
    group = 0
    i = 0
    phrase_words = [p.split() for p in vocab.RELATION_PHRASES]
    while i < n:
        matched = 0
        for words in phrase_words:
            k = len(words)
            if i + k <= n and all(toks[i + j].lower == words[j] for j in range(k)):
                # don't treat bare 'on'/'in'/'at'/'by' before non-entities as
                # relations? keep simple: accept all matches.
                for j in range(k):
                    toks[i + j].kind = "REL"
                    toks[i + j].rel_group = group
                matched = k
                group += 1
                break
        i += matched if matched else 1

    def _np_context(i: int) -> bool:
        """The homograph at i reads as a noun: an NP opener (DET/ADJ/NUM)
        precedes it directly ('the stand'), or it completes a known
        multi-word object with the previous word ('night stand', 'tv
        stand'). A plain preceding noun does NOT qualify — that is the
        subject of a verb reading ('the picture hanging', 'chairs stand')."""
        if i == 0:
            return False
        prev = toks[i - 1]
        if prev.kind in ("DET", "ADJ", "NUM"):
            return True
        bigram = f"{prev.lower} {toks[i].lower}"
        return bigram in vocab.multiword_objects().get(2, ())

    for i, t in enumerate(toks):
        if t.kind == "REL":
            continue
        if not t.text[0].isalnum():
            t.kind = "PUNCT"
        elif t.lower in vocab.DETERMINERS:
            t.kind = "DET"
        elif t.lower in vocab.PRONOUNS:
            t.kind = "PRON"
        elif t.lower in vocab.COPULAS:
            # copula/noun homographs ('stand' in "the night stand", 'can' in
            # "the trash can"): inside an NP they are the noun — spaCy's POS
            # tagger resolves this contextually in the reference; the NP-
            # context check is the rule-based analog. "can not" (from NR3D's
            # cant -> 'can not' fix) is always the modal.
            if (
                vocab.is_object_noun(t.lower)
                and _np_context(i)
                and not (i + 1 < n and toks[i + 1].lower == "not")
            ):
                t.kind = "NOUN_OBJ"
            else:
                t.kind = "COP"
        elif t.lower in vocab.CONJUNCTIONS:
            t.kind = "CONJ"
        elif t.lower.replace(".", "").isdigit() or t.lower in _NUM_WORDS or (
            len(t.lower) > 2 and t.lower[:-2].isdigit() and t.lower[-2:] in ("st", "nd", "rd", "th")
        ):
            t.kind = "NUM"
        elif vocab.is_object_noun(t.lower):
            # 'can not' (NR3D's cant fix) is the modal, never the container
            if not (t.lower == "can" and i + 1 < n and toks[i + 1].lower == "not"):
                t.kind = "NOUN_OBJ"
        elif vocab.is_scene_noun(t.lower):
            t.kind = "NOUN_SCENE"
        elif t.lower in vocab.ATTRIBUTES:
            t.kind = "ADJ"

    # noun/verb homographs heading a relative clause: "the bin that STANDS
    # beside the copier", "a lamp that STANDS in the corner" — after a
    # relativizer whose antecedent is a noun, a noun-tagged homograph is the
    # clause's verb (spaCy tags VBZ/VBP and never chunks it)
    for i in range(2, n):
        if toks[i].kind not in ("NOUN_OBJ", "NOUN_SCENE"):
            continue
        if toks[i - 1].lower not in ("that", "which", "who"):
            continue
        j = i - 2
        while j >= 0 and toks[j].kind == "PUNCT":
            j -= 1
        if j >= 0 and toks[j].kind in ("NOUN_OBJ", "NOUN_SCENE"):
            toks[i].kind = "OTHER"

    # post-nominal spatial superlatives: "the chair nearest the door" — the
    # reference's spaCy chunker splits "the chair" / "the door" into separate
    # noun chunks with "nearest" outside both (amod attaching right); our
    # greedy chunker would otherwise merge the run into one chunk and demote
    # "chair" to a modifier. After a noun or pronoun ("the one nearest the
    # bed") they act as relation words; before a noun ("the closest chair")
    # they stay attributive modifiers.
    for i, t in enumerate(toks):
        if t.kind == "REL" or t.lower not in _SPATIAL_SUPERLATIVES:
            continue
        j = i - 1
        while j >= 0 and toks[j].kind == "PUNCT":
            j -= 1
        if j >= 0 and toks[j].kind in ("NOUN_OBJ", "NOUN_SCENE", "PRON"):
            t.kind = "REL"
            t.rel_group = group
            group += 1

    # multi-word object phrases ("trash can"): retag all member words NOUN_OBJ
    for k, phrases in vocab.multiword_objects().items():
        for i in range(n - k + 1):
            cand = " ".join(toks[i + j].lower for j in range(k))
            if cand in phrases and all(
                toks[i + j].kind in ("NOUN_OBJ", "ADJ", "OTHER", "NOUN_SCENE")
                for j in range(k)
            ):
                for j in range(k):
                    toks[i + j].kind = "NOUN_OBJ"


@dataclasses.dataclass
class _Chunk:
    head_idx: List[int]  # token indices of the head noun(s)
    mod_idx: List[int]  # modifier token indices
    kind: str  # Object | Scene | Pron
    start: int
    end: int  # token index range [start, end)


def _chunk(toks: List[_Tok]) -> List[_Chunk]:
    """Greedy NP chunking: [DET]? (ADJ|NUM)* NOUN+ ; PRON alone."""
    chunks: List[_Chunk] = []
    i, n = 0, len(toks)
    while i < n:
        t = toks[i]
        if t.kind == "PRON":
            # 'that'/'this'/'one' directly before a noun act as determiners
            nxt = toks[i + 1] if i + 1 < n else None
            if nxt is not None and nxt.kind in ("ADJ", "NUM", "NOUN_OBJ", "NOUN_SCENE"):
                t.kind = "DET"
            else:
                chunks.append(_Chunk([i], [], "Pron", i, i + 1))
                i += 1
                continue
        if t.kind in ("DET", "ADJ", "NUM", "NOUN_OBJ", "NOUN_SCENE"):
            start = i
            mods: List[int] = []
            heads: List[int] = []
            noun_kind = None
            while i < n and toks[i].kind in ("DET", "ADJ", "NUM", "NOUN_OBJ", "NOUN_SCENE"):
                k = toks[i].kind
                if (
                    k == "NOUN_SCENE"
                    and toks[i].lower in vocab.TRANSPARENT_SCENE_WORDS
                    and noun_kind == "Object"
                ):
                    # a TRAILING structural word after an object head is an
                    # adverb, not a compound: "the cabinet right as you walk
                    # in" (spaCy tags RB); leading ones stay compounds
                    # ("the back wall")
                    break
                if k in ("ADJ", "NUM"):
                    mods.append(i)
                elif k in ("NOUN_OBJ", "NOUN_SCENE"):
                    heads.append(i)
                    noun_kind = "Object" if k == "NOUN_OBJ" else (noun_kind or "Scene")
                i += 1
            if heads:
                # The trailing run of consecutive noun tokens is the
                # (possibly multi-word) head; earlier detached nouns act as
                # compounds/modifiers: "kitchen counter" -> head, but
                # "kitchen [ADJ] counter" -> kitchen modifies counter.
                tail = [heads[-1]]
                for h in reversed(heads[:-1]):
                    if h == tail[0] - 1:
                        tail.insert(0, h)
                    else:
                        mods.append(h)
                chunks.append(_Chunk(tail, sorted(mods), noun_kind or "Scene", start, i))
            # a det/adj run with no noun is dropped (e.g. trailing "the")
            continue
        i += 1
    return chunks


def _is_transparent(toks: List[_Tok], c: "_Chunk") -> bool:
    """Scene chunk headed only by structural words the reference's entity
    filter drops entirely (left/corner/middle/... — not in its scene-noun
    file, spacy_parser.py:130-163): no node, no subject, no landmark."""
    return c.kind == "Scene" and all(
        toks[h].lower in vocab.TRANSPARENT_SCENE_WORDS for h in c.head_idx
    )


def _rel_groups(toks: List[_Tok]) -> List[List[int]]:
    """Relation phrases as lists of consecutive token indices, text order."""
    by_group: dict = {}
    for i, t in enumerate(toks):
        if t.kind == "REL":
            by_group.setdefault(t.rel_group, []).append(i)
    return [by_group[g] for g in sorted(by_group, key=lambda g: by_group[g][0])]


_SENT_END = frozenset(".;!?")


def _resolve_relations(toks, chunks, node_of_chunk, groups):
    """Resolve each relation phrase to its (subject, landmark) node ids.

    Rule-based analog of the reference's dependency-head walks
    (``spacy_parser.py:221-300`` + ``__find_root`` :461-507): walking
    backward from the relation phrase over non-entity tokens is the analog
    of walking ``token.head`` chains —

    * first entity chunk hit = the clause subject (``__find_root`` case 2,
      "object + object complement": "on the [window] above the desk" —
      *above*'s subject is window);
    * a comma resets attachment to the sentence subject (spaCy attaches
      ", by the bed" to the clause ROOT, whose nsubj is the sentence
      subject — ``__find_root`` case 4 / step-1 nsubj lookup);
    * a conjunction inherits the previous relation's subject in the same
      sentence ("left of the table and behind the desk" — conj lifts
      *behind* to share *left of*'s head, ``__find_rel_by_root``'s conj
      skip);
    * nothing before the phrase in its sentence = omitted subject = node 0
      (the reference's VBN step 3: "placed between other chairs.").

    The landmark is the next entity chunk after the phrase, stopped at
    punctuation/conjunction/another relation (-1 if none) — the reference's
    ``idx_s`` entity the walk started from.

    Scene chunks headed by structural words the reference does not treat as
    entities (``vocab.TRANSPARENT_SCENE_WORDS``: left/corner/middle/...)
    are transparent to both walks, exactly as the reference's head chains
    run through them (its entity filter drops those chunks entirely).
    """
    n = len(toks)
    chunk_at = {}
    transparent = set()
    for ci, c in enumerate(chunks):
        for i in range(c.start, c.end):
            chunk_at[i] = ci
        if _is_transparent(toks, c):
            transparent.add(ci)
    # sentence index per token
    sent_of = [0] * n
    s = 0
    for i, t in enumerate(toks):
        sent_of[i] = s
        if t.kind == "PUNCT" and t.text in _SENT_END:
            s += 1
    # sentence subject: first chunk with a node id in each sentence
    sent_subject: dict = {}
    for ci, c in enumerate(chunks):
        nid = node_of_chunk.get(ci)
        if nid is None:
            continue
        si = sent_of[c.start]
        sent_subject.setdefault(si, nid)

    resolved = []
    prev: dict = {}  # sentence idx -> subject of the previous group there
    for g in groups:
        si = sent_of[g[0]]
        subject = 0
        j = g[0] - 1
        while j >= 0:
            t = toks[j]
            ci = chunk_at.get(j)
            if ci is not None and ci in transparent:
                j = chunks[ci].start - 1
                continue
            if ci is not None and node_of_chunk.get(ci) is not None:
                subject = node_of_chunk[ci]
                break
            if t.kind == "PUNCT":
                if t.text in _SENT_END:
                    subject = 0  # phrase opens its sentence: omitted subject
                else:
                    subject = sent_subject.get(si, 0)
                break
            if t.kind == "CONJ" and si in prev:
                subject = prev[si]
                break
            j -= 1  # DET/ADJ/NUM/COP/OTHER/REL and coref-dropped pronouns
        prev[si] = subject

        landmark = -1
        k = g[-1] + 1
        while k < n:
            t = toks[k]
            ci = chunk_at.get(k)
            if ci is not None and ci in transparent:
                k = chunks[ci].end
                continue
            if ci is not None and node_of_chunk.get(ci) is not None:
                landmark = node_of_chunk[ci]
                break
            if t.kind in ("PUNCT", "CONJ", "REL", "COP"):
                break
            k += 1  # DET/ADJ/NUM/OTHER
        resolved.append((subject, landmark))
    return resolved


def parse(caption: str) -> ParseResult:
    """Decouple a caption. See module docstring for the node schema."""
    toks = _tokenize(caption)
    _classify(toks)
    chunks = _chunk(toks)

    def span(i: int) -> Span:
        return (toks[i].start, toks[i].end)

    # main entity: first Object chunk whose head is not wall/floor
    # (spacy_parser.py:168-183)
    main_i = None
    for ci, c in enumerate(chunks):
        if c.kind == "Object" and not all(
            toks[h].lower in vocab.NON_MAIN_OBJECTS for h in c.head_idx
        ):
            main_i = ci
            break
    if main_i is None:
        for ci, c in enumerate(chunks):
            if c.kind == "Object":
                main_i = ci
                break

    nodes: List[Node] = []
    groups = _rel_groups(toks)
    relations = [span(i) for g in groups for i in g]

    def build_edges(node_of_chunk):
        resolved = _resolve_relations(toks, chunks, node_of_chunk, groups)
        return [
            Edge(subject, landmark, [span(i) for i in g])
            for g, (subject, landmark) in zip(groups, resolved)
        ]

    def main_rels(edges):
        # only relations whose subject resolves to node 0 reach the main
        # node (reference edge filter at spacy_parser.py:436-447)
        return [s for e in edges if e.subject_id == 0 for s in e.rel_char_span]

    if main_i is None:
        # hard-coded fallbacks for nouns the parser misses: 'trash can',
        # 'urinal', 'cardboard' become the main entity
        # (spacy_parser.py:389-432). The vocab usually classifies these as
        # object nouns already; this guards utterances where tagging failed.
        for i, t in enumerate(toks):
            fb_span = None
            if t.lower == "trash" and i + 1 < len(toks) and toks[i + 1].lower == "can":
                fb_span = [span(i), span(i + 1)]
            elif t.lower in ("urinal", "cardboard"):
                fb_span = [span(i)]
            if fb_span is not None:
                main = Node(0, "Object")
                main.target_char_span = fb_span
                # the fallback noun is the only entity: every relation's
                # backward walk lands on it (or on nothing) -> node 0
                fb_chunk = _Chunk([i], [], "Object", i, i + len(fb_span))
                chunks.append(fb_chunk)
                edges = build_edges({len(chunks) - 1: 0})
                main.rel_char_span = main_rels(edges)
                return ParseResult([main], relations, edges)
        return ParseResult(nodes, relations, build_edges({}))

    main_chunk = chunks[main_i]
    main_head_text = " ".join(toks[h].lower for h in main_chunk.head_idx)
    main = Node(0, "Object")
    main.target_char_span = [span(h) for h in main_chunk.head_idx]
    main.mod_char_span = [span(m) for m in main_chunk.mod_idx]
    main.lemma_head = " ".join(vocab.lemma(toks[h].lower) for h in main_chunk.head_idx)
    nodes.append(main)

    node_of_chunk = {main_i: 0}
    ent_id = 0
    for ci, c in enumerate(chunks):
        if ci == main_i:
            continue
        if _is_transparent(toks, c):
            continue  # not an entity to the reference: no node
        if c.kind == "Pron":
            if ci > main_i:  # pronouns before the main entity are dropped
                main.pron_char_span.extend(span(h) for h in c.head_idx)
                node_of_chunk[ci] = 0  # coref: subject walks land on node 0
            continue
        head_text = " ".join(toks[h].lower for h in c.head_idx)
        first = c.head_idx[0]
        preceded_by_the = first > 0 and toks[first - 1].lower == "the"
        if c.kind == "Object" and head_text == main_head_text and (
            preceded_by_the or ci > main_i
        ):
            # repeated mention of the main object -> coref to node 0
            # (spacy_parser.py:208-215); spans count as pronoun spans and
            # its modifiers flow to the main node (spacy_parser.py:436-447).
            main.pron_char_span.extend(span(h) for h in c.head_idx)
            main.mod_char_span.extend(span(m) for m in c.mod_idx)
            node_of_chunk[ci] = 0
            continue
        ent_id += 1
        node = Node(ent_id, c.kind)
        node.target_char_span = [span(h) for h in c.head_idx]
        node.mod_char_span = [span(m) for m in c.mod_idx]
        node.lemma_head = " ".join(vocab.lemma(toks[h].lower) for h in c.head_idx)
        nodes.append(node)
        node_of_chunk[ci] = ent_id

    edges = build_edges(node_of_chunk)
    main.rel_char_span = main_rels(edges)

    # predicate attributes: [main | pron] COP (ADJ|NUM|CONJ)* -> mods of main
    # ("the chair is black and wooden", spacy_parser.py:303-323)
    for i, t in enumerate(toks):
        if t.kind != "COP":
            continue
        subj_ok = False
        j = i - 1
        while j >= 0 and toks[j].kind == "PUNCT":
            j -= 1
        if j >= 0:
            if toks[j].kind == "PRON":
                subj_ok = j > main_chunk.start or any(
                    toks[j].start == s for s, _ in main.pron_char_span
                )
            elif main_chunk.start <= j < main_chunk.end:
                subj_ok = True
            elif any(toks[j].start == s for s, _ in main.pron_char_span):
                subj_ok = True
        if not subj_ok:
            continue
        # Collect the predicative run. When the run leads into a noun, the
        # modifiers after the last DET/COP boundary belong to THAT noun's
        # chunk, not the subject ("it has a black frame": "black" is amod of
        # "frame", not acomp — reference spacy_parser.py:97-125); conjoined
        # predicative adjectives before the boundary stay with the subject
        # ("is brown and has three cushions" keeps "brown").
        k = i + 1
        run: List[int] = []
        boundary = 0  # run entries collected before the last DET/COP
        while k < len(toks) and toks[k].kind in ("ADJ", "NUM", "CONJ", "DET", "COP"):
            if toks[k].kind in ("ADJ", "NUM"):
                run.append(k)
            elif toks[k].kind in ("DET", "COP"):
                boundary = len(run)
            k += 1
        if k < len(toks) and toks[k].kind in ("NOUN_OBJ", "NOUN_SCENE"):
            run = run[:boundary]
        for k in run:
            if span(k) not in main.mod_char_span:
                main.mod_char_span.append(span(k))

    return ParseResult(nodes, relations, edges)


def decoupled_spans(caption: str) -> dict:
    """Convenience dict of the five span groups for positive-map building.

    Keys: main, modifiers, pronouns, relations, others, auxi — each a list of
    (char_start, char_end) spans into ``caption``.
    """
    result = parse(caption)
    main = result.main
    others: List[Span] = []
    for node in result.nodes:
        if node.node_id != 0 and node.node_type == "Object":
            others.extend(node.target_char_span)
    auxi = result.auxi_entity
    return {
        "main": list(main.target_char_span) if main else [],
        "modifiers": list(main.mod_char_span) if main else [],
        "pronouns": list(main.pron_char_span) if main else [],
        "relations": list(main.rel_char_span) if main else [],
        "others": others,
        "auxi": list(auxi.target_char_span) if auxi else [],
        "auxi_lemma": auxi.lemma_head if auxi else "",
    }
