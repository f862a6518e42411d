"""The port's detection prompts and dataset mixing against the JAX package's.

``DetectionPromptDataset`` examples (the fixed 18-class prompt at evaluation,
the random prompt at training, the height and multiview channels, the
detected-box stream) and ``MixedDataset`` batches, bit-identical to
``eda_tpu.data.detection_prompt``'s on the same scans and tokenizer.
"""

import numpy as np
import pytest

from eda_tpu.data import detection_prompt as jax_prompt
from eda_tpu.data.dataset import GroundingDataset as JaxDataset
from eda_tpu.models.bpe import BPETokenizer as JaxBPE
from eda_tpu_torch.data import detection_prompt
from eda_tpu_torch.data.bpe import BPETokenizer
from eda_tpu_torch.data.dataset import GroundingDataset
from torch_parity import assert_same_example

LABELS = (("chair", 300), ("table", 400), ("sofa", 200), ("lamp", 150), ("kitchen cabinets", 250),
          ("trash can", 100), ("office chair", 120), ("bookshelf", 300), ("door", 90),
          ("window", 80), ("bed", 400), ("desk", 200), ("toilet", 60), ("sink", 60))


class FakeScan:
    """A scan stand-in: ``pc``, ``color``, ``three_d_objects`` and ``object_by_id``."""

    def __init__(self, rng, n=4000, objects=LABELS):
        self.pc = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
        self.color = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        self.three_d_objects = []
        start = 0
        for label, count in objects:
            self.three_d_objects.append({"object_id": len(self.three_d_objects),
                                         "points": np.arange(start, start + count),
                                         "instance_label": label})
            start += count

    def object_by_id(self, oid):
        return oid


@pytest.fixture(scope="module")
def scans():
    rng = np.random.default_rng(0)
    return {"scene0": FakeScan(rng), "scene1": FakeScan(rng, objects=LABELS[:3]),
            "scene2": FakeScan(rng, objects=(("lamp", 100), ("chair", 200)))}


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    import real_data_fixtures

    d = tmp_path_factory.mktemp("vocab")
    real_data_fixtures.write_bpe_vocab(d, real_data_fixtures.fixture_corpus())
    return d


@pytest.fixture(scope="module")
def multiview(tmp_path_factory, scans):
    import h5py

    path = tmp_path_factory.mktemp("mv") / "enet_feats_maxpool.hdf5"
    rng = np.random.default_rng(3)
    with h5py.File(path, "w") as f:
        for sid, scan in scans.items():
            f[sid] = rng.normal(size=(len(scan.pc), 128)).astype(np.float32)
    return str(path)


CASES = {
    "eval": dict(split="val", augment=False),
    "train": dict(split="train", augment=True, use_color=True),
    "train-no-color": dict(split="train", augment=True, use_color=False, seed=5),
    "height-multiview": dict(split="train", augment=True, use_height=True, multiview=True),
    "butd-oracle": dict(split="val", augment=False, butd_gt=True),
    "butd-fallback": dict(split="train", augment=True),
}


@pytest.mark.parametrize("tokenized", ["hash", "bpe"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_prompt_examples_equal_jax(scans, vocab, multiview, case, tokenized):
    kw = dict(CASES[case])
    if kw.pop("multiview", False):
        kw["multiview_path"] = multiview
    butd = case.startswith("butd")
    if tokenized == "bpe":
        got_ds = detection_prompt.DetectionPromptDataset(
            scans, tokenizer=BPETokenizer.from_pretrained(str(vocab)), **kw)
        want_ds = jax_prompt.DetectionPromptDataset(
            scans, tokenizer=JaxBPE.from_pretrained(str(vocab)), **kw)
    else:
        got_ds = detection_prompt.DetectionPromptDataset(scans, vocab_size=512, **kw)
        want_ds = jax_prompt.DetectionPromptDataset(scans, vocab_size=512, **kw)
    assert got_ds.scan_ids == want_ds.scan_ids and len(got_ds) == 3
    prompts = set()
    for idx in range(8):
        got, want = got_ds.example(idx, butd=butd), want_ds.example(idx, butd=butd)
        assert_same_example(got, want, f"{case} {idx}")
        assert got["targets"]["box_label_mask"].sum() >= 1
        prompts.add(got["inputs"]["text_ids"].tobytes())
    # evaluation asks the fixed prompt; training draws random ones half of the time
    assert len(prompts) == 1 if kw["split"] == "val" else len(prompts) > 2
    assert_same_example(got_ds.batch([2, 0, 5], butd=butd), want_ds.batch([2, 0, 5], butd=butd),
                        case)


def test_mixed_batches_equal_jax(scans, vocab):
    from eda_tpu.data.decouple import decoupled_spans

    annos = [{"scan_id": "scene0", "target_id": t, "distractor_ids": [], "anchors": [],
              "anchor_ids": [], "utterance": f"the {name} near the door", "target": name,
              "dataset": "scanrefer", "decoupled": decoupled_spans(f"the {name} near the door")}
             for t, (name, _) in enumerate(LABELS[:4])]
    tok, jax_tok = BPETokenizer.from_pretrained(str(vocab)), JaxBPE.from_pretrained(str(vocab))
    got = detection_prompt.MixedDataset(
        [GroundingDataset(scans, [dict(a) for a in annos], tokenizer=tok),
         detection_prompt.DetectionPromptDataset(scans, tokenizer=tok)], [1, 10])
    want = jax_prompt.MixedDataset(
        [JaxDataset(scans, [dict(a) for a in annos], tokenizer=jax_tok),
         jax_prompt.DetectionPromptDataset(scans, tokenizer=jax_tok)], [1, 10])
    assert len(got) == len(want) == 4 + 10 * 3
    for idx in ([0, 5, 33, 3], [34, 12, 1, 20]):
        assert_same_example(got.batch(idx), want.batch(idx), str(idx))
