"""The port's platform probes (funny_lidar_slam_torch.ops.probes), the
counterparts of the TPU probes in tools/pallas_smoke.py. On the CPU the
wrappers take the plain versions; each must equal, exactly, the expression
the TPU probe asserts its kernel with (`x * 2`, `np.asarray(tab)[idx]`,
`np.take_along_axis`), at the TPU probe's shapes. The TPU probes themselves
use pltpu memory spaces and scalar prefetch, which do not run here; the
kernels are held against the plain versions on the card by chip_smoke.py.
lane_gather's plain version is also held to jnp.take_along_axis, and a
NumPy mirror of its kernel's thread mapping to the plain version."""

import re
import shutil
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funny_lidar_slam_torch.ops import cuda_build, probes

torch.set_num_threads(1)

NAMES = ["scale2", "row_gather_loop", "row_gather_vector", "lane_gather", "dma_rows"]


@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_tpu_probe_expression(name):
    inputs = probes.probe_inputs("cpu")[name]
    before = getattr(probes, name).launches
    out = getattr(probes, name)(*inputs)
    a = [t.numpy() for t in inputs]
    if name == "scale2":
        ref = a[0] * 2.0
    elif name == "lane_gather":
        ref = np.take_along_axis(a[0], a[1], axis=1)
    else:
        ref = a[0][a[1]]
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)
    assert getattr(probes, name).launches == before == 0  # the CPU launches nothing


def test_gathers_clamp_indices():
    """Out-of-range indices clamp to [0, C), as a JAX gather clamps."""
    tab = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    idx = torch.tensor([-3, 0, 9, 10, 1000], dtype=torch.int32)
    ref = tab.numpy()[[0, 0, 9, 9, 9]]
    for fn in (probes.row_gather_loop, probes.row_gather_vector, probes.dma_rows):
        np.testing.assert_array_equal(fn(tab, idx).numpy(), ref)
    lanes = torch.tensor([[-1, 3, 4], [7, 0, 2]], dtype=torch.int32)
    np.testing.assert_array_equal(probes.lane_gather(tab[:2], lanes).numpy(),
                                  tab.numpy()[[[0, 0, 0], [1, 1, 1]], [[0, 3, 3], [3, 0, 2]]])


def test_main_runs_on_the_cpu(capsys):
    assert probes.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu")
    assert [ln.split(":")[0] for ln in lines[1:]] == NAMES
    assert all(": OK" in ln for ln in lines[1:])


def test_wrappers_raise_on_mixed_devices_and_wrong_types():
    """Inputs off the CPU never take the plain version; mixed devices and
    types a kernel does not take raise before any launch."""
    tab = torch.zeros((16, 8), dtype=torch.float32)
    idx = torch.zeros(4, dtype=torch.int32)
    meta_tab = torch.empty((16, 8), dtype=torch.float32, device="meta")
    meta_idx = torch.empty(4, dtype=torch.int32, device="meta")
    for fn in (probes.row_gather_loop, probes.row_gather_vector, probes.dma_rows):
        with pytest.raises(ValueError, match="CUDA"):
            fn(tab, meta_idx)  # mixed devices
        with pytest.raises(ValueError, match="CUDA"):
            fn(meta_tab, meta_idx)  # a device that is not CUDA
    with pytest.raises(ValueError, match="CUDA"):
        probes.lane_gather(meta_tab, meta_idx.reshape(1, 4))
    with pytest.raises(ValueError, match="CUDA"):
        probes.scale2(meta_tab)
    with pytest.raises(TypeError):
        probes._check("row_gather_loop", tab.double(), idx)
    with pytest.raises(TypeError):
        probes._check("row_gather_loop", tab, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        probes._check("lane_gather", tab.T, None)
    with pytest.raises(ValueError, match="16-byte"):
        probes._check("dma_rows", torch.zeros((4, 6)), idx, rows16=True)
    assert all(p.launches == 0 for p in probes.PROBES)


@pytest.mark.parametrize("d,ok", [(4, True), (1536, True), (probes.DMA_MAX_D, True),
                                  (probes.DMA_MAX_D + 4, False), (4096, False)])
def test_dma_rows_row_limit(d, ok):
    """dma_rows takes rows up to DMA_MAX_D (3072) floats, a cover row at
    plane 128, and refuses wider ones before any launch. Meta tensors stand
    for the card: an accepted width reaches the device check."""
    tab = torch.empty((16, d), dtype=torch.float32, device="meta")
    idx = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA" if ok else f"at most {probes.DMA_MAX_D}"):
        probes.dma_rows(tab, idx)
    assert probes.dma_rows.launches == 0


@pytest.mark.parametrize("name", ["row_gather_loop", "row_gather_vector", "dma_rows"])
def test_plain_at_cover_index_pattern(name):
    """The row gathers on the CPU equal NumPy indexing for sorted distinct
    row ids (the cover-row measurement's pattern), at cover-row width and a
    small C; the CPU launches nothing."""
    c, d = 64, 1536
    idx = probes.cover_index(c, 50, seed=3)
    assert len(np.unique(idx)) == 50 and (np.diff(idx) > 0).all() and idx.dtype == np.int32
    tab = np.random.default_rng(4).normal(size=(c, d)).astype(np.float32)
    fn = getattr(probes, name)
    out = fn(torch.from_numpy(tab), torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), tab[idx])
    assert fn.launches == 0


def test_lib_path_hashes_source_and_headers(tmp_path, monkeypatch):
    """A library is named by its source and every csrc/*.cuh header, so an
    edited header rebuilds it."""
    (tmp_path / "probes.cu").write_text('#include "async_copy.cuh"\n')
    (tmp_path / "async_copy.cuh").write_text("// v1\n")
    monkeypatch.setattr(cuda_build, "_CSRC", tmp_path)
    first = cuda_build.lib_path("probes")
    assert cuda_build.lib_path("probes") == first
    (tmp_path / "async_copy.cuh").write_text("// v2\n")
    second = cuda_build.lib_path("probes")
    assert second != first and second.parent == cuda_build.BUILD_DIR
    (tmp_path / "other.cuh").write_text("// new\n")
    assert cuda_build.lib_path("probes") not in (first, second)
    (tmp_path / "other.cuh").unlink()
    (tmp_path / "probes.cu").write_text('#include "async_copy.cuh"\n// edited\n')
    assert cuda_build.lib_path("probes") not in (first, second)


def test_a_variant_built_with_defines_has_its_own_library(tmp_path, monkeypatch):
    """A build with nvcc -D flags (a profiling build: -DFLS_STAGE_CLOCKS)
    is named by its flags too, beside the plain build, so neither replaces
    the other; `build_all` starts it with the others and keys every output
    by (name, flags), () for a plain build; `variant` loads each build
    once."""
    (tmp_path / "gn_loop.cu").write_text("// source\n")
    monkeypatch.setattr(cuda_build, "_CSRC", tmp_path)
    plain = cuda_build.lib_path("gn_loop")
    staged = cuda_build.lib_path("gn_loop", ("-DFLS_STAGE_CLOCKS",))
    assert staged != plain and staged.parent == plain.parent
    assert staged.name.startswith("libgn_loop-fls_stage_clocks-")
    assert cuda_build.lib_path("gn_loop", ("-DOTHER",)) not in (plain, staged)
    started = []
    monkeypatch.setattr(cuda_build, "_start_build",
                        lambda name, defines=(): started.append((name, defines))
                        or (None, tmp_path / f"{name}{len(started)}.so", None))
    logs = cuda_build.build_all(["gn_loop"], [("gn_loop", ["-DFLS_STAGE_CLOCKS"])])
    assert started == [("gn_loop", ()), ("gn_loop", ("-DFLS_STAGE_CLOCKS",))]
    assert set(logs) == {("gn_loop", ()), ("gn_loop", ("-DFLS_STAGE_CLOCKS",))}
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: mock.MagicMock(path=path))
    lib = cuda_build.variant("gn_loop", ["-DFLS_STAGE_CLOCKS"])
    assert lib.path == str(staged)
    assert cuda_build.variant("gn_loop", ("-DFLS_STAGE_CLOCKS",)) is lib
    assert cuda_build.library("gn_loop") is cuda_build.library("gn_loop") is not lib
    assert cuda_build.library("gn_loop").path == str(plain)


def test_no_fallback_without_a_toolkit():
    """Without a built library or nvcc the kernels' build raises; it never
    returns a plain result."""
    if cuda_build.lib_path("probes").exists() or shutil.which("nvcc"):
        pytest.skip("a built kernel library or nvcc is present")
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.library("probes")


CSRC = Path(probes.__file__).resolve().parents[1] / "csrc"


def lane_gather_inputs(b, d, j, seed):
    """x [B, D] float32 and idx [B, J] int32 with in-range indices and, in
    about a third of the lanes, indices at or above D or below -D (the int32
    extremes among them): out of range either way, so the clamped gather
    takes lane D-1 or 0, as jnp.take_along_axis(mode="clip") does. (Between
    -D and -1 the two differ: JAX counts such an index from the end, the
    port's gathers clamp it to 0, as lax.gather does.)"""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, d)).astype(np.float32)
    idx = rng.integers(0, d, (b, j))
    out = rng.random((b, j)) < 1 / 3
    idx[out] = np.where(rng.random(out.sum()) < 0.5, rng.integers(d, 3 * d, out.sum()),
                        rng.integers(-3 * d, -d, out.sum()))
    idx.flat[:2] = [-2 ** 31, 2 ** 31 - 1]
    return x, idx.astype(np.int32)


@pytest.mark.parametrize("shape", [(256, 512, 128), (37, 70, 13), (5, 9, 3)])
def test_lane_gather_plain_matches_jax_take_along_axis(shape):
    """lane_gather on CPU tensors (its plain version) equals
    jnp.take_along_axis at the TPU probe's shape (B 256, D 512, J 128) and
    at ragged ones (J not a multiple of 4, B*J neither), out-of-range
    indices clamped."""
    x, idx = lane_gather_inputs(*shape, seed=shape[0])
    ref = np.asarray(jnp.take_along_axis(jnp.asarray(x), jnp.asarray(idx), axis=1, mode="clip"))
    out = probes.lane_gather(torch.from_numpy(x), torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert probes.lane_gather.launches == 0


def lane_gather_mirror(x, idx, aligned=True):
    """csrc/probes.cu's lane_gather_kernel in NumPy: the B*J outputs flat,
    thread t < n4 takes outputs 4t..4t+3 (one 16-byte load of their
    indices), its row b = 4t / J and column stepped one by one into the next
    row; the rest (B*J mod 4, or all of them where idx or out is not
    16-byte aligned) one a thread, row e / J."""
    b_rows, d = x.shape
    j = idx.shape[1]
    flat, total = idx.reshape(-1), b_rows * j
    n4 = total // 4 if aligned else 0
    out = np.empty(total, np.float32)
    for t in range(n4):
        b, c = divmod(4 * t, j)
        for u in range(4):
            out[4 * t + u] = x[b, min(max(int(flat[4 * t + u]), 0), d - 1)]
            c += 1
            if c == j:
                c, b = 0, b + 1
    for e in range(4 * n4, total):
        out[e] = x[e // j, min(max(int(flat[e]), 0), d - 1)]
    return out.reshape(b_rows, j)


@pytest.mark.parametrize("shape", [(256, 512, 128), (37, 70, 13), (5, 9, 3), (3, 4, 1)])
@pytest.mark.parametrize("aligned", [True, False])
def test_a_mirror_of_the_lane_gather_kernel_matches_the_plain_version(shape, aligned):
    x, idx = lane_gather_inputs(*shape, seed=7)
    ref = probes.lane_gather_plain(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(lane_gather_mirror(x, idx, aligned), ref)


def test_probe_signatures_match_the_kernel_source():
    """Every probe's C entry point against its ctypes signature in
    ops/cuda_build.py; lane_gather_kernel stages nothing in shared memory,
    loads its indices and stores its outputs as 16-byte vectors, and its
    launcher spreads the outputs over at least as many blocks as SMs: at
    the TPU probe's shape and 132 SMs, 256 blocks of a warp."""
    text = (CSRC / "probes.cu").read_text()
    ctypes_kinds = {cuda_build._P: "ptr", cuda_build._I: "int", cuda_build._F: "float"}
    sigs = cuda_build.SIGNATURES["probes"]
    found = dict(re.findall(r'extern "C" int (probe_\w+)\(([^)]*)\)', text))
    assert set(found) == set(sigs)
    for fn, params in found.items():
        kinds = ["ptr" if "*" in q else q.split()[0] for q in params.split(",")]
        argtypes, restype = sigs[fn]
        assert [ctypes_kinds[a] for a in argtypes] == kinds and restype is cuda_build._I, fn
    body = re.search(r"lane_gather_kernel\(.*?\n}\n", text, re.S).group(0)
    assert "__shared__" not in body and "__syncthreads" not in body
    assert "const int4*" in body and "float4*" in body and "__ldg(x" in body
    launch = re.search(r'int probe_lane_gather_launch\(.*?\n}\n', text, re.S).group(0)
    assert "cudaDevAttrMultiProcessorCount" in launch
    assert re.search(r"std::max\(32, std::min\(kThreads, threads / std::max\(sms, 1\) / 32 \* 32\)\)",
                     launch)
    threads, sms = 256 * 128 // 4, 132
    block = max(32, min(256, threads // sms // 32 * 32))
    assert (block, -(-threads // block)) == (32, 256)
