"""The port's native TSV reader and FLOPs count against the JAX package's.

``musketeer_tpu_torch/native`` builds its own copy of ``tsv_reader.cpp`` with
g++ into its ``build/`` directory; its batched rows must equal the JAX
package's native rows and the pure-Python reader's, and the joint loader's
fetches must go through it. ``utils/flops.py`` must give the JAX package's
numbers for every preset.
"""

import dataclasses

import numpy as np
import pytest

import musketeer_tpu.config as jax_config
from musketeer_tpu.utils import flops as jax_flops
from musketeer_tpu_torch import config, native
from musketeer_tpu_torch.data.file_dataset import FileDataset
from musketeer_tpu_torch.utils import flops

needs_gxx = pytest.mark.skipif(not native.available(), reason="no g++ to build the native reader")


@needs_gxx
def test_native_rows_match_jax_and_python(tmp_path):
    """JAX ``tests/test_data.py::test_native_batched_rows``' file and calls."""
    from musketeer_tpu.native import NativeTsv as JaxNativeTsv, available as jax_available

    p = tmp_path / "nat.tsv"
    p.write_text("a\tb\n\ncc\tdd\n")  # includes an empty row
    nt = native.NativeTsv(str(p))
    assert nt.rows([0, 1, 2]) == ["a\tb", "", "cc\tdd"]
    assert nt.rows(np.asarray([2, 0])) == ["cc\tdd", "a\tb"]
    assert nt.rows([]) == []
    with pytest.raises(IndexError):
        nt.rows([0, 99])
    if jax_available():
        jt = JaxNativeTsv(str(p))
        assert jt.rows([2, 1, 0, 0]) == nt.rows([2, 1, 0, 0])
        np.testing.assert_array_equal(jt.offsets(), nt.offsets())
        jt.close()
    nt.close()
    # the library is built under the build directory, never beside the source
    assert native._lib_path().is_file()
    assert native._lib_path().parent.parent == native.BUILD_ROOT
    assert not (native._DIR / "libtsv.so").exists()


@needs_gxx
def test_get_batch_is_one_native_call(tmp_path):
    p = tmp_path / "rows.tsv"
    p.write_text("".join(f"id{i}\tpayload-{i}\n" for i in range(25)))
    ds = FileDataset(str(p), cached_index=False)
    idx = [0, 24, 7, 7, 3, 30]  # dup + wraparound
    native.NativeTsv.batch_calls = 0
    batch = ds.get_batch(idx)
    assert native.NativeTsv.batch_calls == 1
    assert batch == [ds[i] for i in idx]  # the row-by-row Python reader
    assert batch[1] == ["id24", "payload-24"]
    assert ds.get_batch([]) == []
    s1 = FileDataset(str(p), shard_id=1, num_shards=3, cached_index=False)
    assert s1.get_batch([0, 1]) == [s1[0], s1[1]]
    # the native index equals the Python scan's
    py = FileDataset.__new__(FileDataset)
    py.file_path = str(p)
    py._native_index = lambda: None
    np.testing.assert_array_equal(py._build_or_load_index(False), ds._offsets)
    # the handle does not travel with a pickled dataset
    assert ds.__getstate__()["_native"] is None
    ds.close()


def test_get_batch_without_gxx(tmp_path, monkeypatch):
    """Without a toolchain the rows come from the Python reader, unchanged."""
    monkeypatch.setattr(native, "available", lambda: False)
    p = tmp_path / "rows.tsv"
    p.write_text("".join(f"r{i}\tv{i}\n" for i in range(5)))
    ds = FileDataset(str(p), cached_index=False)
    assert ds.get_batch([4, 1]) == [["r4", "v4"], ["r1", "v1"]]
    assert ds._native is False


@pytest.mark.parametrize("preset", sorted(config.ARCH_PRESETS))
def test_flops_match_jax(preset):
    ct, cj = config.ARCH_PRESETS[preset](), jax_config.ARCH_PRESETS[preset]()
    assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
    calls = [
        ("resnet_flops", (ct.resnet_layers, 480, 384), {}),
        ("encoder_flops", (80,), {}),
        ("encoder_flops", (80,), dict(img_size=480)),
        ("encoder_flops", (80,), dict(img_size=480, n_patches=196)),
        ("decoder_flops", (20, 980), {}),
        ("incremental_decode_flops", (16, 980), {}),
        ("caption_inference_flops", (2, 40, 480, 5, 16), {}),
        ("seq2seq_fwd_flops", (2, 80, 20), dict(img_size=480, rdrop=True)),
        ("seq2seq_fwd_flops", (4, 60, 30), dict(img_size=256, n_patches=100)),
        ("seq2seq_fwd_flops", (3, 120, 40), {}),
    ]
    for name, args, kw in calls:
        cfgs = ((), ()) if name == "resnet_flops" else ((ct,), (cj,))
        ours = getattr(flops, name)(*cfgs[0], *args, **kw)
        assert ours == getattr(jax_flops, name)(*cfgs[1], *args, **kw), (name, args, kw)
        assert ours > 0
    assert flops.TRAIN_FWD_BWD_MULT == jax_flops.TRAIN_FWD_BWD_MULT
