"""The port's detection and pretraining tasks, the joint loader's patch
subsampling and the CLI's model configs against the JAX package.

Builders: the same seeds and TSV rows give the same ``Example``s, row for row
and field for field (tokens, pixels, masks, conf, extras), exactly. The
loader: a head task's ``sample_patch_order`` equals the JAX loader's. The
detection task: ``parse_boxes`` and the box metric on seeded token rows, and
``evaluate`` end to end on a seeded ``ofa_tiny`` (2 + 2 layers, fp32, the
preset's XLA branch), equal JAX's (the loss within 1e-5 relative). The CLI:
``train``, ``evaluate`` and ``evaluate-all`` build the JAX CLI's
``ModelConfig`` for the same arguments.
"""

import dataclasses
import random
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import musketeer_tpu.data as jdata
import musketeer_tpu.training as jtraining
from musketeer_tpu import cli as jcli
from musketeer_tpu import tasks as jtasks
from musketeer_tpu.config import ofa_tiny
from musketeer_tpu.models import ofa as jofa
from musketeer_tpu.tasks import MusketeerDataLoader as JaxLoader
from musketeer_tpu.tasks import SubTaskSpec as JaxSpec
from musketeer_tpu.tasks.detection import DetectionTask as JaxDetectionTask
from musketeer_tpu.tokenization import default_vocab as jax_vocab
from musketeer_tpu.utils.eval_utils import match_detections as jax_match
import musketeer_tpu_torch.data as tdata
import musketeer_tpu_torch.training as ttraining
from musketeer_tpu_torch import cli as tcli
from musketeer_tpu_torch import tasks as ttasks
from musketeer_tpu_torch.config import ModelConfig
from musketeer_tpu_torch.data import FileDataset
from musketeer_tpu_torch.params import from_jax
from musketeer_tpu_torch.tasks import MusketeerDataLoader, SubTaskSpec
from musketeer_tpu_torch.tasks.detection import DetectionTask
from musketeer_tpu_torch.tokenization import default_vocab
from musketeer_tpu_torch.utils.eval_utils import match_detections
from tests.test_tasks import write_tsv
from tests.test_torch_port_normformer import one_thread  # noqa: F401
from tests.test_torch_port_search import numpy_tree
from tests.test_torch_port_tasks import noise_image_b64, row_dependent


def _rows(seed=11):
    rng = np.random.RandomState(seed)
    img = lambda w, h: noise_image_b64(rng, w, h)
    codes = lambda: " ".join(str(c) for c in rng.randint(0, 8192, 16))
    words = "the quick brown fox jumps over a lazy dog near the old river bank at dawn".split()
    return {
        # two or three objects a row, at row-dependent places
        "detection": [[str(i), img(64, 48), "&&".join(
            f"{x:.1f},{y:.1f},{x + 20 + i:.1f},{y + 15:.1f},{c},{n}"
            for x, y, c, n in [(2.0 + i, 3.0, 1, "dog"), (30.0, 20.0 + i, 2, "red car")]
            + [(10.0, 25.0, 3, "cat")] * (i % 2))] for i in range(4)],
        "text_infilling": [[" ".join(rng.permutation(words)[:10 + i])] for i in range(4)],
        "image_text_pair": [[str(i), img(48, 40), f"a thing number {i} on a table"]
                            for i in range(4)],
        "image_text_matching": [[str(i), img(32, 32), f"a dog and a cat near tree {i}",
                                 "dog&&cat&&tree"] for i in range(4)],
        "pure_image": [[str(i), img(40, 40), codes()] for i in range(3)],
        "visual_grounding": [[str(i), img(64, 48), f"the object {i}",
                              f"{2 + i}.0,3.0,{40 + i}.0,30.0"] for i in range(4)],
    }


# id: (builder, rows, constructor kwargs); every builder at patch size 32
BUILDERS = {
    "detection_train": ("DetectionBuilder", "detection", dict(split="train", seed=3)),
    "detection_valid": ("DetectionBuilder", "detection", dict(split="valid")),
    "text_infilling": ("TextInfillingBuilder", "text_infilling", dict(seed=5, mask_ratio=0.4)),
    "image_text_pair_train": ("ImageTextPairBuilder", "image_text_pair", dict(split="train", seed=2)),
    "image_text_pair_valid": ("ImageTextPairBuilder", "image_text_pair", dict(split="valid")),
    "image_text_matching": ("ImageTextMatchingBuilder", "image_text_matching",
                            dict(split="train", seed=4, p_negative=0.6)),
    "pure_image": ("PureImageBuilder", "pure_image", dict(code_image_size=16)),
    "visual_grounding_train": ("VisualGroundingBuilder", "visual_grounding",
                               dict(split="train", seed=6)),
    "region_caption_valid": ("VisualGroundingBuilder", "visual_grounding",
                             dict(split="valid", mode="region_caption")),
}


def _assert_examples_equal(out, ref, where):
    for f in dataclasses.fields(ref):
        a, b = getattr(out, f.name), getattr(ref, f.name)
        if f.name == "extras":
            assert set(a) == set(b), where
            for k in b:
                if isinstance(b[k], np.ndarray):
                    np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where} {k}")
                else:
                    assert a[k] == b[k], (where, k)
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, (where, f.name)
            np.testing.assert_array_equal(a, b, err_msg=f"{where} {f.name}")
        else:
            assert a == b, (where, f.name, a, b)


@pytest.mark.parametrize("case", list(BUILDERS))
def test_builders_match_jax(case):
    name, rows, kw = BUILDERS[case]
    kw = dict(description="tep", patch_image_size=32, **kw)
    ref_b = getattr(jdata, name)(jax_vocab(), **kw)
    out_b = getattr(tdata, name)(default_vocab(), **kw)
    refs, outs = [], []
    for builder, acc in ((ref_b, refs), (out_b, outs)):
        random.seed(9)  # RandAugment draws from Python's random
        acc.extend(builder(row) for row in _rows()[rows])
    for i, (out, ref) in enumerate(zip(outs, refs)):
        _assert_examples_equal(out, ref, f"{case} row {i}")
    assert len({tuple(e.src_ids) + tuple(e.target_ids) for e in outs}) >= 2


def test_uint8_transport_builders_match_jax():
    """With the loader's uint8 transport the detection builder emits raw pixels."""
    refs, outs = [], []
    for mod, vocab, acc in ((jdata, jax_vocab(), refs), (tdata, default_vocab(), outs)):
        b = mod.DetectionBuilder(vocab, description="tep", patch_image_size=32, split="train")
        b.transport_uint8 = True
        acc.extend(b(row) for row in _rows()["detection"])
    for i, (out, ref) in enumerate(zip(outs, refs)):
        assert out.patch_image.dtype == np.uint8
        _assert_examples_equal(out, ref, f"row {i}")


@pytest.fixture(scope="module")
def tsvs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pretrain_tsv")
    rows = _rows()
    rows["caption"] = [[str(i), noise_image_b64(np.random.RandomState(i), 64, 64),
                        f"a thing {i}&&another thing {i}"] for i in range(4)]
    return {k: write_tsv(d / f"{k}.tsv", v) for k, v in rows.items()}


def test_joint_loader_sample_patch_order_matches_jax(tsvs):
    """The head task subsampled to 6 of its 16 patches beside pure_image and
    detection: each step's every field, the orders too, equal the JAX loader's."""
    def specs(cls):
        return [cls("caption", tsvs["caption"], batch_size=2, sample_patch_num=6,
                    task_kwargs=dict(patch_image_size=64)),
                cls("pure_image", tsvs["pure_image"], batch_size=2,
                    task_kwargs=dict(code_image_size=16)),
                cls("detection", tsvs["detection"], batch_size=2,
                    task_kwargs=dict(patch_image_size=32))]
    jl = JaxLoader(jax_vocab(), specs(JaxSpec), seed=3)
    tl = MusketeerDataLoader(default_vocab(), specs(SubTaskSpec), seed=3)
    ref, out = list(jl.epoch_iterator()), list(tl.epoch_iterator())
    tl.close()
    assert len(out) == len(ref) == 2
    orders = []
    for bj, bt in zip(ref, out):
        for name in bj:
            for field, a, b in zip(bj[name]._fields, bj[name], bt[name]):
                assert (a is None) == (b is None), (name, field)
                if a is not None:
                    np.testing.assert_array_equal(b.numpy(), np.asarray(a).astype(b.numpy().dtype))
        order = bt["caption"].sample_patch_order
        assert order.shape == (1, 2, 6) and bt["pure_image"].sample_patch_order is None
        assert bool(bt["pure_image"].code_masks.all())
        orders.append(order.numpy())
    assert not np.array_equal(orders[0], orders[1])


def _detection_rows(task, vocab, seed=5):
    """Seeded token rows: each row's target boxes and labels, with stray
    tokens between the groups and a pad tail."""
    rng = np.random.RandomState(seed)
    b = task.builder("valid")
    rows = []
    for i, row in enumerate(_rows()["detection"]):
        ex = b(row)
        toks = list(ex.target_ids[:-1])
        toks.insert(4 + i % 3, int(rng.randint(4, 3000)))  # a stray token inside a group
        toks += [int(vocab.bin_start + rng.randint(0, 1000)) for _ in range(i % 3)]
        rows.append((np.asarray(toks + [vocab.eos, vocab.pad], np.int64), ex))
    return rows


def test_detection_parse_boxes_and_metric_match_jax():
    tj = JaxDetectionTask(jax_vocab(), description="base", patch_image_size=32)
    tt = DetectionTask(default_vocab(), description="base", patch_image_size=32)
    parsed = []
    for (toks, ex_t), (_, ex_j) in zip(_detection_rows(tt, tt.vocab), _detection_rows(tj, tj.vocab)):
        w_r, h_r = ex_t.extras["w_resize_ratio"], ex_t.extras["h_resize_ratio"]
        gt, gj = tt.parse_boxes(toks, w_r, h_r), tj.parse_boxes(toks, w_r, h_r)
        assert [label for _, label in gt] == [label for _, label in gj]
        np.testing.assert_array_equal(np.asarray([b for b, _ in gt]), np.asarray([b for b, _ in gj]))
        pb = np.asarray([b for b, _ in gt], np.float64).reshape(-1, 4)
        labels = [label.strip() for _, label in gt]
        gt_labels = [label.strip() for label in ex_t.extras["labels"]]
        assert (match_detections(pb, labels, ex_t.extras["boxes"], gt_labels)
                == jax_match(pb, labels, ex_j.extras["boxes"], gt_labels))
        parsed.append(tuple(map(tuple, pb.round(3))))
    assert len(set(parsed)) >= 2


def test_detection_evaluate_matches_jax(tsvs):
    cfg_j = dataclasses.replace(ofa_tiny(), dtype="float32", encoder_layers=2,
                                decoder_layers=2, resnet_layers=(1, 1, 1))
    cfg_t = ModelConfig(**dataclasses.asdict(cfg_j))
    tree = row_dependent(numpy_tree(cfg_t, 0))
    tasks = (JaxDetectionTask(jax_vocab(), description="base", patch_image_size=32),
             DetectionTask(default_vocab(), description="base", patch_image_size=32))
    for t in tasks:
        t.set_generation_overrides(max_len_b=10, min_len=2)
    ref = tasks[0].evaluate(jax.tree.map(jnp.asarray, tree), cfg_j,
                            jdata.FileDataset(tsvs["detection"]), batch_size=2)
    out = tasks[1].evaluate(from_jax(tree, cfg_t, "cpu", torch.float32), cfg_t,
                            FileDataset(tsvs["detection"]), batch_size=2)
    loss_j, loss_t = ref.pop("loss"), out.pop("loss")
    assert abs(loss_t - loss_j) <= 1e-5 * abs(loss_j)
    assert out == ref and out["n"] == 4


# ---------------------------------------------------------------------------
# the CLI's model configs
# ---------------------------------------------------------------------------

class _Captured(Exception):
    pass


def _jax_config(argv):
    """The ModelConfig the JAX CLI hands its train loop or task."""
    seen = {}

    def grab(cfg):
        seen["cfg"] = cfg
        raise _Captured

    class Task(jtasks.CaptionTask):
        def evaluate(self, params, model_cfg, *a, **kw):
            grab(model_cfg)

    with mock.patch.object(jofa, "init_ofa_params", return_value={}), \
            mock.patch.object(jtraining, "train_loop", lambda cfg, model_cfg, *a, **kw: grab(model_cfg)), \
            mock.patch.dict(jtasks.TASK_REGISTRY, {"caption": Task}), \
            pytest.raises(_Captured):
        jcli.main(argv)
    return seen["cfg"]


def _port_config(argv):
    seen = {}

    def grab(cfg):
        seen["cfg"] = cfg
        raise _Captured

    class Task(ttasks.CaptionTask):
        def evaluate(self, params, model_cfg, *a, **kw):
            grab(model_cfg)

    with mock.patch.object(tcli, "_seeded_params", return_value={}), \
            mock.patch.object(ttraining, "train_loop", lambda cfg, model_cfg, *a, **kw: grab(model_cfg)), \
            mock.patch.dict(ttasks.TASK_REGISTRY, {"caption": Task}), \
            pytest.raises(_Captured):
        tcli.main(argv + ["--device", "cpu"])
    return seen["cfg"]


CLI_CASES = {
    "train": ["train", "--tasks", "caption={caption}"],
    "train_no_flash": ["train", "--tasks", "caption={caption}", "--no-flash"],
    "train_unroll": ["train", "--tasks", "caption={caption}", "--unroll-layers"],
    "train_microbatches": ["train", "--tasks", "caption={caption}", "--microbatches", "2",
                           "--pipeline-interleave", "2"],
    "train_interleave_alone": ["train", "--tasks", "caption={caption}",
                               "--pipeline-interleave", "2"],
    "evaluate": ["evaluate", "--task", "caption", "--data", "{caption}"],
    "evaluate_all": ["evaluate-all", "--tasks", "caption={caption}"],
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_model_config_matches_jax(tsvs, case):
    """The commands build the JAX CLI's ModelConfig: evaluate keeps the
    preset's ``use_flash_attention`` (False, the XLA branch); train sets it
    from ``--no-flash``, and the pipeline's fields from ``--microbatches``
    (``--pipeline-interleave`` alone is ignored, as there)."""
    argv = [a.format(**tsvs) for a in CLI_CASES[case]] + ["--arch", "ofa_tiny"]
    ref, out = _jax_config(argv), _port_config(argv)
    assert dataclasses.asdict(out) == dataclasses.asdict(ref)
    assert out.use_flash_attention == (case.startswith("train") and case != "train_no_flash")
    assert (out.pipeline_microbatches, out.pipeline_interleave) == (
        (2, 2) if case == "train_microbatches" else (0, 1))
