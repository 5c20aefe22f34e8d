"""The full joint step over the model, pipe and seq axes on gloo ranks, as
``dryrun_multirank(4, layouts=...)`` runs it (``run_layouts``, then
``dryrun._check`` against the one-process run): ``dryrun.axes_job``
(``ofa_tiny`` cut to 4 + 4 layers and a 1024-row vocabulary, ResNet (1, 1,
1), fp32, dropout off; three tasks, two micro-batches of 4 rows, R-Drop, an
active drop-worst, EMA) on 4 ranks in each layout of ``dryrun.AXES_LAYOUTS`` (model 2 × fsdp 2,
model 4, pipe 4 with M = 4, data 2 × pipe 2 interleaved, seq 4), and a
checkpoint moved between model 2 × pipe 2 and one rank, in one spawn:
metrics to 1e-5 relative, the parameters, AdamW moments and EMA after the
update to 1e-5 of each tree's largest value (``_check`` raises otherwise),
and each rank's state bytes as ``leaf_spec`` reckons them (a pipe stage holds
its own layers). In the same spawn, at data 2 × pipe 2, where the pipeline's
gate is closed (the XLA branch, with a batch of code targets) and the stages
gather their stacks: three updates against one rank's; and a
checkpoint saved there, loaded at one rank and at model 2 × pipe 2 bit for
bit. The JAX meshes hold the same axes in ``test_torch_port_tensor_parallel.py``,
``_pipeline.py`` and ``_ring.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from musketeer_tpu_torch.config import MeshConfig
from musketeer_tpu_torch.parallel.data_parallel import reckoned_state_bytes
from musketeer_tpu_torch.parallel.dryrun import (
    AXES_LAYOUTS, _check, axes_job, run_job, run_layouts,
)
from musketeer_tpu_torch.parallel.mesh import Mesh
from musketeer_tpu_torch.training.train_step import TaskBatch

ROWS = 2  # demo_job(n): 2n rows a task, the fewest every layout splits
SMALL = dict(vocab_size=1024, padded_vocab_size=1024)  # the demo's tokens are below 1000


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this file's work in the test process, as the
    entry-point files run theirs: beside the suite's other workers one
    thread runs these small ops faster than many."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


GATE_UPDATES = 3
DATA2_PIPE2 = MeshConfig(pipe=2)  # of 4 ranks: data 2 x pipe 2


def _gate_closed_job():
    """``axes_job`` under the pipeline (M = 2) on the XLA branch, where the
    pipeline's gate is closed, with the caption task and a task whose rows
    are code targets (which close the decoder's gate on the flash branch),
    three updates of one micro-batch. Drop-worst is off: at random weights the code targets'
    token losses lie within rounding of each other, and which of two such
    tokens is dropped differs between any two layouts (data 4 against one
    rank too), which moves the next update past 1e-5."""
    job = axes_job(None, n=ROWS, pipeline_microbatches=2, **SMALL)
    job.model_cfg = dataclasses.replace(job.model_cfg, use_flash_attention=False)
    job.crit_cfg = dataclasses.replace(job.crit_cfg, drop_worst_ratio=0.0)
    rs = np.random.RandomState(3)
    B = 2 * ROWS
    tok = lambda T: torch.from_numpy(rs.randint(4, 1000, (1, B, T)))
    codes = TaskBatch(src_tokens=tok(6), prev_output_tokens=tok(5), target=tok(5),
                      code_masks=torch.ones(1, B, dtype=torch.bool))
    caption = TaskBatch(*[None if x is None else x[:1] for x in job.steps[0]["caption"]])
    step = {"caption": caption, "image_gen": codes}  # one micro-batch an update
    return dataclasses.replace(job, steps=[step] * GATE_UPDATES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """→ (each layout's rank-0 record, the one-process record and its job,
    the checkpoint runs: one rank straight, model 2 × pipe 2 straight, each
    resumed from the other's checkpoint after the first of two updates, and
    the checkpoint that the gate-closed run saved at data 2 × pipe 2 after
    its first update, loaded at one rank and at model 2 × pipe 2; the
    gate-closed run's record and one rank's)."""
    base = axes_job("pipe4", n=ROWS, **SMALL)
    base.model_cfg = dataclasses.replace(base.model_cfg, pipeline_microbatches=2)
    base.steps = base.steps * 2
    job = lambda **kw: dataclasses.replace(base, **kw)
    one, two, dp = (str(tmp_path_factory.mktemp(n)) for n in ("one", "two", "dp"))
    straight_one = run_job(job(save_dir=one))
    two_by_two = MeshConfig(model=2, pipe=2)
    gate = _gate_closed_job()
    load_dp = dataclasses.replace(gate, steps=[], load_dir=dp)
    recs = run_layouts(4, [(AXES_LAYOUTS[n][0], axes_job(n, n=ROWS, **SMALL))
                           for n in AXES_LAYOUTS] + [
        (two_by_two, job(save_dir=two)), (two_by_two, job(steps=base.steps[1:], load_dir=one)),
        (DATA2_PIPE2, dataclasses.replace(gate, save_dir=dp)), (two_by_two, load_dp)])
    layouts = dict(zip(AXES_LAYOUTS, recs))
    k = len(AXES_LAYOUTS)
    ckpt = dict(straight_one=straight_one, straight_two=recs[k], resumed_two=recs[k + 1],
                resumed_one=run_job(job(steps=base.steps[1:], load_dir=two)),
                saved_dp=_read_checkpoint(dp, gate), loaded_two=recs[k + 3],
                loaded_one=run_job(load_dp))
    ref = axes_job(None, n=ROWS, **SMALL)
    return layouts, (run_job(ref), ref), ckpt, (recs[k + 2], run_job(gate))


def _read_checkpoint(save_dir: str, job) -> dict:
    """``checkpoint_last`` in ``save_dir`` as a record's state leaves, read
    into the full state of ``job``'s tree."""
    from musketeer_tpu_torch.params import map_leaves
    from musketeer_tpu_torch.training import init_train_state
    from musketeer_tpu_torch.training.checkpoint import load_checkpoint
    from musketeer_tpu_torch.training.train_state import named_leaves

    params = map_leaves(lambda t: t.detach().clone(), job.params)  # loaded into in place
    template = init_train_state(params, job.optim_cfg, ema_decay=job.ema_decay)
    state, _ = load_checkpoint(save_dir, template)
    leaves = lambda tree: [t.detach().clone() for _, t in named_leaves(tree)]
    return dict(step=state.step, params=leaves(state.params), mu=leaves(state.opt_state["mu"]),
                nu=leaves(state.opt_state["nu"]), ema=leaves(state.ema_params))


@pytest.mark.parametrize("layout", list(AXES_LAYOUTS))
def test_dryrun_multirank_axes(runs, layout):
    """The layout's step against one rank's; each rank's state (parameters,
    moments, EMA) is the bytes ``leaf_spec`` reckons for its place on the
    mesh, and a pipe stage holds less than the whole."""
    layouts, (want, job) = runs[:2]
    _check(layout, layouts[layout], want)
    sizes = AXES_LAYOUTS[layout][0].axis_sizes(4)
    reckoned = [reckoned_state_bytes(job.params, Mesh(sizes, r, {}), 4) for r in range(4)]
    assert layouts[layout]["rank_state_bytes"] == reckoned
    if sizes[3] > 1:
        assert max(reckoned) < want["state_bytes"]


def test_gate_closed_stacks_gather_over_pipe(runs):
    """At data 2 × pipe 2 with each stage holding half of each stack, three
    updates on the XLA branch and a code-target batch, where the pipeline's
    gate is closed and every stage gathers both stacks, equal one rank's:
    every update's metrics, and the parameters, moments and EMA after the
    last."""
    got, want = runs[3]
    assert len(got["metrics"]) == len(want["metrics"]) == GATE_UPDATES
    for i, (a, b) in enumerate(zip(got["metrics"], want["metrics"])):
        _check(f"gate closed, update {i}", dict(got, metrics=[a]), dict(want, metrics=[b]))
    assert max(got["rank_state_bytes"]) < want["state_bytes"]


def test_checkpoint_moves_from_data2_pipe2(runs):
    """A checkpoint saved at data 2 × pipe 2 (the stages' layers gathered, as
    read back from the file) loads at one rank and at model 2 × pipe 2
    (resharded there, gathered back for the record) bit for bit."""
    c = runs[2]
    saved = c["saved_dp"]
    for got in (c["loaded_one"], c["loaded_two"]):
        assert got["step"] == saved["step"] == 1
        for key in ("params", "mu", "nu", "ema"):
            assert all(torch.equal(a, b) for a, b in zip(got[key], saved[key])), key


def test_checkpoint_moves_between_model2_pipe2_and_one_rank(runs):
    """A checkpoint saved after the first of two updates at model 2 × pipe 2
    (GPipe, M = 2; the whole state, gathered) resumes at one rank, and one
    saved at one rank resumes at model 2 × pipe 2: the second update's
    metrics and state equal the straight run's of the other layout."""
    c = runs[2]
    for got, want in ((c["resumed_one"], c["straight_two"]),
                      (c["resumed_two"], c["straight_one"])):
        assert got["step"] == want["step"] == 2
        _check("resume", dict(got, metrics=got["metrics"][-1:]),
               dict(want, metrics=want["metrics"][-1:]))


def _fails_on_rank_1(mesh, device):
    import torch.distributed as dist

    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")
    dist.all_reduce(torch.zeros(1))  # rank 0 waits in a collective for rank 1
    return mesh.rank


def test_a_rank_that_raises_fails_the_spawn():
    """A rank that raises ends the spawn at once (its peers, left in a
    collective, are ended with it), well inside the spawn's timeout."""
    import time

    from musketeer_tpu_torch.parallel.dryrun import run_fn

    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails|exit|terminated"):
        run_fn(2, _fails_on_rank_1, timeout=120)
    assert time.monotonic() - t0 < 60
