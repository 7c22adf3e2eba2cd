"""The port's prototype bloom probe (``benchmarks.exp_bloom``) against the
reference's ``benchmarks/exp_bloom.py`` on the CPU: its tables, its NumPy
model ``np_probe`` and its Pallas ``kernel`` in interpret mode; the grid
form tile by tile, with pad rows that are never read; and the CUDA
kernel's per-thread code (csrc/proto_probe.cuh) compiled for the CPU.
Every output is an integer, so the tolerance is zero throughout."""

import importlib.util
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pattern_matching_torch.benchmarks import exp_bloom as port
from tpu_pattern_matching_torch.ops import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE = dict(port.TILE, tiles=1)


def load_reference():
    """A fresh copy of the reference's ``benchmarks/exp_bloom.py`` (not a
    package): its generator has drawn only the tables, and its kernel is a
    new function, so what one test patches no other test sees."""
    bench = os.path.join(REPO, "benchmarks")
    saved = list(sys.path)
    sys.path.insert(0, bench)
    try:
        spec = importlib.util.spec_from_file_location(
            "reference_exp_bloom", os.path.join(bench, "exp_bloom.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved  # the module puts "." on the path
    return mod


def reference_for(seed, monkeypatch):
    """The reference with the tables of ``make_tables(seed)``, and the
    port's tables and generator."""
    ref = load_reference()
    bloom, mix1, mix2, rng = port.make_tables(seed)
    for name, value in (("BLOOM", bloom), ("MIX1", mix1), ("MIX2", mix2)):
        monkeypatch.setattr(ref, name, value)
    return ref, bloom, mix1, mix2, rng


def reference_windows(ref, data):
    """The gram bytes of the reference's ``main``."""
    G, S, C, Q = ref.G, ref.S, data.shape[1], ref.Q
    return np.stack([data[: G * S].reshape(G, S, C)[:, k, :]
                     for k in range(Q)], axis=-1)


def plain(data, bloom, mix1, mix2, **geom):
    return port.probe_plain(torch.from_numpy(data), torch.from_numpy(bloom),
                            mix1, mix2, **geom).numpy()


def test_tables_and_first_draw_equal_reference(capsys):
    ref = load_reference()
    bloom, mix1, mix2, rng = port.make_tables(0)
    for got, want in ((bloom, ref.BLOOM), (mix1, ref.MIX1),
                      (mix2, ref.MIX2)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    seen = []

    def stop(data, interpret=False):  # the reference main's first launch
        seen.append(np.asarray(data))
        raise RuntimeError("stopped after the first draw")

    ref.run_probe = stop
    ref.main()
    assert "stopped after the first draw" in capsys.readouterr().out
    data = rng.randint(0, 256, size=(port.G * port.S + port.Q, port.C))
    np.testing.assert_array_equal(seen[0], data.astype(np.uint8))


@pytest.mark.parametrize("seed", [0, 1])
def test_one_tile_equals_np_probe_and_pallas_kernel(seed, monkeypatch):
    ref, bloom, mix1, mix2, rng = reference_for(seed, monkeypatch)
    data = rng.randint(0, 256, size=(port.G * port.S + port.Q, port.C)
                       ).astype(np.uint8)
    want_np = ref.np_probe(reference_windows(ref, data))
    want = np.asarray(ref.run_probe(jnp.asarray(data), interpret=True))
    got = plain(data, bloom, mix1, mix2, **ONE)
    assert got.dtype == np.int8 and got.shape == (1, port.G, port.C)
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[0], want_np.astype(np.int8))
    np.testing.assert_array_equal(
        port.np_probe(port.np_windows(data), bloom, mix1, mix2), want_np)
    out = port.run_probe(torch.from_numpy(data), torch.from_numpy(bloom),
                         mix1, mix2)
    np.testing.assert_array_equal(out.numpy(), want)
    assert 0 < int(want.sum()) < want.size // 10
    if seed == 0:
        assert int(want.sum()) == 264  # the reference main's input


def test_grid_form_equals_pallas_kernel_per_tile(monkeypatch):
    ref, bloom, mix1, mix2, _ = reference_for(0, monkeypatch)
    pitch = port.G * port.S + port.Q
    data = np.random.RandomState(5).randint(
        0, 256, size=(3 * pitch, port.C)).astype(np.uint8)
    got = plain(data, bloom, mix1, mix2, **dict(ONE, tiles=3))
    assert got.shape == (3, port.G, port.C)
    for i in range(3):
        tile = jnp.asarray(data[i * pitch : (i + 1) * pitch])
        np.testing.assert_array_equal(
            got[i], np.asarray(ref.run_probe(tile, interpret=True)))
    assert got.sum() > 0


def grid_data(tiles, lanes, seed):
    return np.random.RandomState(seed).randint(
        0, 256, size=(tiles * (port.TT + port.PADR), lanes)).astype(np.uint8)


def test_grid_geometry_equals_np_probe_and_skips_pad_rows(monkeypatch):
    # K5's own tiles (64 strided rows, stride 7, 8 pad rows), 3 of them
    # at 256 lanes
    ref, bloom, mix1, mix2, _ = reference_for(0, monkeypatch)
    pitch = port.TT + port.PADR
    data = grid_data(3, 256, 6)
    geom = dict(port.GRID, tiles=3)
    got = plain(data, bloom, mix1, mix2, **geom)
    assert got.shape == (3, port.GT, 256)
    for i in range(3):
        tile = data[i * pitch : i * pitch + port.TT]
        win = np.stack([tile.reshape(port.GT, port.S, 256)[:, k, :]
                        for k in range(port.Q)], axis=-1)
        np.testing.assert_array_equal(got[i], ref.np_probe(win))
    # the pad rows and the row after each gram's q bytes are never read
    unread = np.zeros(3 * pitch, bool)
    for i in range(3):
        unread[i * pitch + port.TT : (i + 1) * pitch] = True
        unread[i * pitch + port.Q : i * pitch + port.TT : port.S] = True
    garbage = data.copy()
    garbage[unread] = 255 - garbage[unread]
    np.testing.assert_array_equal(plain(garbage, bloom, mix1, mix2, **geom),
                                  got)
    out = port.run_grid(torch.from_numpy(garbage), torch.from_numpy(bloom),
                        mix1, mix2)
    np.testing.assert_array_equal(out.numpy(), got)
    assert got.sum() > 0


HOST_CASES = {  # name: (rows, stride, q, pitch, tiles, lanes, kbanks, v)
    "one-tile": (port.G, port.S, port.Q, port.G * port.S + port.Q, 1,
                 port.C, 6, 4),
    "grid": (port.GT, port.S, port.Q, port.TT + port.PADR, 3, 256, 6, 4),
    "overlapping-grams": (10, 3, 5, 35, 2, 68, 3, 8),
    "q1-k1-v1": (5, 1, 1, 5, 4, 4, 1, 1),
    "q8-k12": (9, 8, 8, 80, 2, 36, 12, 2),
}


@pytest.mark.parametrize("name", list(HOST_CASES))
def test_kernel_thread_code_equals_plain(name):
    rows, stride, q, pitch, tiles, lanes, k, v = HOST_CASES[name]
    geom = dict(rows=rows, stride=stride, q=q, pitch=pitch, tiles=tiles)
    rng = np.random.RandomState(len(name))
    if (k, v) == (port.KBANKS, port.V):
        bloom, mix1, mix2, _ = port.make_tables(len(name))
    else:  # every bit of the words, the sign bit too, set at random
        bloom = rng.randint(-(2**31), 2**31, size=(k, v, 128)).astype(
            np.int32)
        mix1 = rng.randint(1, 2**31, size=q) | 1
        mix2 = rng.randint(1, 2**31, size=q) | 1
    data = rng.randint(0, 256, size=(tiles * pitch, lanes)).astype(np.uint8)
    want = plain(data, bloom, mix1, mix2, **geom)
    got = kernels.proto_probe_on_host(torch.from_numpy(data),
                                      torch.from_numpy(bloom), mix1, mix2,
                                      **geom)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


def test_rejected_arguments_raise():
    bloom, mix1, mix2, rng = port.make_tables(0)
    b = torch.from_numpy(bloom)
    ok = torch.from_numpy(rng.randint(0, 256, size=(286, 512)).astype(
        np.uint8))
    with pytest.raises(ValueError, match="multiple of 4"):
        port.run_probe(ok[:, :510], b, mix1, mix2)
    with pytest.raises(ValueError, match="not 1 tiles"):
        port.run_probe(ok[:280], b, mix1, mix2)
    with pytest.raises(ValueError, match="geometry"):
        port.probe_plain(ok, b, mix1, mix2, **dict(ONE, rows=42))
    with pytest.raises(ValueError, match="power of two"):
        port.run_probe(ok, b[:, :3].contiguous(), mix1, mix2)
    with pytest.raises(ValueError, match="multipliers"):
        port.run_probe(ok, b, mix1[:5], mix2)
    with pytest.raises(ValueError, match="needs CUDA"):
        kernels.launch_proto_probe(ok, b, mix1, mix2, kind="tile", **ONE)
    # the kernel's own checks, through its CPU harness
    with pytest.raises(RuntimeError, match="rejected"):
        kernels.proto_probe_on_host(ok, b, mix1, mix2, **dict(ONE, rows=42))


def test_main_on_cpu_and_no_fallback(capsys, monkeypatch):
    monkeypatch.setattr(port, "TILES", 2)  # a small grid on this host
    assert port.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "ok = True  hits: 264 / 264" in out
    assert "bloom probe k=6 V=4 stride=7:" in out and "not a device time" \
        in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            port.main([])
