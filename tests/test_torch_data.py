"""The port's data layer (``founddiff_tpu_torch.data``) against the JAX
package's on synthetic Mayo trees: every sample, name and dose label bit for
bit (the paired augmentation's RNG order included), the loader's batches in
its shuffled order on the serial and the native-pool path, and the native
reader against ``np.load``."""

import os

import numpy as np
import pytest

from founddiff_tpu import data as jdata
from founddiff_tpu.data.loader import Loader as JLoader
from founddiff_tpu_torch import data as tdata
from founddiff_tpu_torch.data import native
from founddiff_tpu_torch.data.loader import Loader as TLoader
from test_data import _write_tree


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mayo"))
    _write_tree(root, "train512")
    _write_tree(root, "test", n=4)
    dirs = [("Mayo2016_2d", "test", "quarter_1mm"), ("Mayo2016_2d", "test", "full_1mm"),
            ("Mayo2016_2d", "train", "quarter_1mm"), ("Mayo2016_2d", "train", "full_1mm"),
            ("CQ500_2d", "test", "sim-0.25"), ("CQ500_2d", "test", "full_1mm")]
    rng = np.random.RandomState(1)
    for parts in dirs:  # the Mayo-2016 and CQ500 sources
        p = os.path.join(root, *parts)
        os.makedirs(p)
        for i in range(3):
            np.save(os.path.join(p, f"m-{parts[-1]}-{i}.npy"),
                    (1024 + 300 * rng.randn(16, 16)).astype(np.float32))
    return root


def _same_samples(a, b, n):
    for i in range(n):
        for x, y in zip(a[i], b[i]):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y, err_msg=f"sample {i}")


@pytest.mark.parametrize("phase", ["train512", "test"])
@pytest.mark.parametrize("doses,stride,subset", [((2, 4, 6, 10), 2, "multi"),
                                                 ((2, 10), 1, "multi"),
                                                 ((10,), 1, "head_1_10")])
def test_pdf_dataset_bit_identical(tree, phase, doses, stride, subset):
    kw = dict(root=tree, doses=doses, num=100, stride=stride, subset=subset)
    j, t = jdata.PDFDataset(phase, **kw), tdata.PDFDataset(phase, **kw)
    assert len(t) == len(j) > 0
    assert t.ldct_paths == j.ldct_paths
    for i in range(len(j)):
        assert t.load_name(i) == j.load_name(i)
        assert t.load_name(i, sub_dir=True) == j.load_name(i, sub_dir=True)
        assert t.dose_label(i) == j.dose_label(i)
        assert t.sample_paths(i) == j.sample_paths(i)
    # the paired RNG advances per sample: two passes in order
    for _ in range(2):
        _same_samples([j[i] for i in range(len(j))], [t[i] for i in range(len(t))], len(j))


@pytest.mark.parametrize("phase,source", [("test", "mayo16"), ("train", "mayo16"),
                                          ("test", "cq500")])
def test_mayo16_dataset_bit_identical(tree, phase, source):
    j = jdata.Mayo16Dataset(phase, root=tree, source=source)
    t = tdata.Mayo16Dataset(phase, root=tree, source=source)
    assert len(t) == len(j) == 3
    assert [t.load_name(i, True) for i in range(3)] == [j.load_name(i, True) for i in range(3)]
    _same_samples([j[i] for i in range(3)], [t[i] for i in range(3)], 3)


@pytest.mark.parametrize("phase", ["train512", "test"])
def test_dose_dataset_bit_identical(tree, phase):
    j = jdata.DoseDataset(phase, root=tree, anatomies=("ab", "lung"))
    t = tdata.DoseDataset(phase, root=tree, anatomies=("ab", "lung"))
    assert t.paths == j.paths and len(t) > 0
    for i in range(len(j)):
        (ja, jb), jl = j[i]
        (ta, tb), tl = t[i]
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tb, jb)
        assert tl == jl and tl.dtype == jl.dtype


def test_define_label_and_lists(tree):
    for p in ("/x/full_1mm/ab-1.npy", "/x/quarter_1mm/ab-1.npy", "/x/quarter_1mm/lung-1.npy",
              "/x/sim-0.10/head-sim-0.10-3.npy", "/x/sim-0.05/ab-sim-0.05-3.npy",
              "/x/sim-0.33/ab-sim-0.33-0.npy", "/x/sim-0.17/ab-sim-0.17-9.npy"):
        assert tdata.define_label(p) == jdata.define_label(p)
    assert tdata.DOSE_DIRS == jdata.DOSE_DIRS
    pattern = os.path.join(tree, "Mayo2020_ab_2d", "test", "*", "*")
    assert tdata.sorted_list(pattern) == jdata.sorted_list(pattern)


@pytest.mark.parametrize("decode_threads", [0, 3])
@pytest.mark.parametrize("batch_size,shuffle,drop_last", [(4, True, True), (5, True, False),
                                                          (1, False, False)])
def test_loader_batches_match_jax(tree, decode_threads, batch_size, shuffle, drop_last):
    """Same batches in the same order for a seed, augmentation included: the
    shuffle's RandomState and the transform RNG advance as in the JAX loader,
    on the serial path and on the native pool's."""
    kw = dict(root=tree, doses=(2, 4), num=100, stride=1)
    lkw = dict(batch_size=batch_size, shuffle=shuffle, drop_last=drop_last, seed=3,
               prefetch=2, decode_threads=decode_threads)
    jl = JLoader(jdata.PDFDataset("train512", **kw), **lkw)
    tl = TLoader(tdata.PDFDataset("train512", **kw), **lkw)
    if decode_threads:
        assert tl._native_pool() is not None, "pool path not taken"
    assert len(tl) == len(jl)
    for epoch in range(2):
        jb, tb = list(jl), list(tl)
        assert len(tb) == len(jb) == len(jl)
        for a, b in zip(jb, tb):
            for x, y in zip(a, b):
                assert isinstance(y, np.ndarray)
                np.testing.assert_array_equal(y, x)


def test_loader_pool_matches_serial_and_cycle(tree):
    ds = tdata.PDFDataset("test", root=tree, num=100, stride=1)
    pooled = TLoader(ds, batch_size=4, shuffle=False, prefetch=0, decode_threads=3)
    serial = TLoader(ds, batch_size=4, shuffle=False, prefetch=0, decode_threads=0)
    for bp, bs in zip(pooled, serial):
        for xp, xs in zip(bp, bs):
            np.testing.assert_array_equal(xp, xs)
    it = tdata.cycle(TLoader(ds, batch_size=4, shuffle=False))
    n = len(ds) // 4
    first = [next(it) for _ in range(n)]
    again = next(it)  # the second epoch starts over
    np.testing.assert_array_equal(again[0], first[0][0])


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int16])
@pytest.mark.parametrize("shape", [(7, 9), (1, 16, 16)])
def test_read_npy_matches_np_load(tmp_path, dtype, shape):
    assert native.reader() == "native", "the native reader did not build"
    arr = (np.random.RandomState(0).rand(*shape) * 1000 - 500).astype(dtype)
    p = str(tmp_path / "a.npy")
    np.save(p, arr)
    out = native.read_npy(p)
    assert out.dtype == np.float32 and out.shape == arr.shape
    np.testing.assert_array_equal(out, np.load(p).astype(np.float32))


@pytest.mark.parametrize("decode_threads", [0, 3])
def test_native_decodes_are_counted(tree, tmp_path, decode_threads):
    """``native.decodes`` counts every file of a pass, on the serial path
    (``read_npy``) and on the pool's (``PrefetchPool.wait``); a file that
    falls back to ``np.load`` is not counted."""
    ds = tdata.PDFDataset("test", root=tree, num=100, stride=1)
    native.decodes = 0
    batches = list(TLoader(ds, batch_size=3, shuffle=False, drop_last=False,
                           decode_threads=decode_threads))
    assert sum(len(b[0]) for b in batches) == len(ds)
    assert native.decodes == 2 * len(ds)
    p = str(tmp_path / "b.npy")
    np.save(p, np.ones((4, 4), bool))  # a dtype the native reader refuses
    np.testing.assert_array_equal(native.read_npy(p), np.ones((4, 4), np.float32))
    assert native.decodes == 2 * len(ds)


def test_native_library_is_built_in_the_package(tmp_path):
    path = native.build()
    assert path is not None and os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("libfastloader_")
    pool = native.PrefetchPool(num_threads=1)
    with pytest.raises(IOError):
        pool.wait(pool.submit(str(tmp_path / "missing.npy")))
    pool.close()
