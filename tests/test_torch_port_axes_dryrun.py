"""The full joint step over the model, pipe and seq axes on gloo ranks, as
``dryrun_multirank(4, layouts=...)`` runs it (``run_layouts``, then
``dryrun._check`` against the one-process run): ``dryrun.axes_job``
(``ofa_tiny`` cut to 4 + 4 layers and a 1024-row vocabulary, ResNet (1, 1,
1), fp32, dropout off; three tasks, two micro-batches of 4 rows, R-Drop, an
active drop-worst, EMA) on 4 ranks in each layout of ``dryrun.AXES_LAYOUTS`` (model 2 × fsdp 2,
model 4, pipe 4 with M = 4, data 2 × pipe 2 interleaved, seq 4), and a
checkpoint moved between model 2 × pipe 2 and one rank, in one spawn:
metrics to 1e-5 relative, the parameters, AdamW moments and EMA after the
update to 1e-5 of each tree's largest value (``_check`` raises otherwise).
The JAX meshes hold the same axes in ``test_torch_port_tensor_parallel.py``,
``_pipeline.py`` and ``_ring.py``.
"""

import dataclasses

import pytest
import torch

from musketeer_tpu_torch.config import MeshConfig
from musketeer_tpu_torch.parallel.dryrun import (
    AXES_LAYOUTS, _check, axes_job, run_job, run_layouts,
)

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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """→ (each layout's rank-0 record, the one-process record, the checkpoint
    runs: one rank straight, model 2 × pipe 2 straight, each resumed from
    the other's checkpoint after the first of two updates)."""
    base = axes_job("pipe4", n=ROWS, **SMALL)
    base.model_cfg = dataclasses.replace(base.model_cfg, pipeline_microbatches=2)
    base.steps = base.steps * 2
    job = lambda **kw: dataclasses.replace(base, **kw)
    one, two = (str(tmp_path_factory.mktemp(n)) for n in ("one", "two"))
    straight_one = run_job(job(save_dir=one))
    two_by_two = MeshConfig(model=2, pipe=2)
    recs = run_layouts(4, [(AXES_LAYOUTS[n][0], axes_job(n, n=ROWS, **SMALL))
                           for n in AXES_LAYOUTS] + [
        (two_by_two, job(save_dir=two)), (two_by_two, job(steps=base.steps[1:], load_dir=one))])
    layouts = dict(zip(AXES_LAYOUTS, recs))
    ckpt = dict(straight_one=straight_one, straight_two=recs[-2], resumed_two=recs[-1],
                resumed_one=run_job(job(steps=base.steps[1:], load_dir=two)))
    return layouts, run_job(axes_job(None, n=ROWS, **SMALL)), ckpt


@pytest.mark.parametrize("layout", list(AXES_LAYOUTS))
def test_dryrun_multirank_axes(runs, layout):
    layouts, want, _ = runs
    _check(layout, layouts[layout], want)


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
