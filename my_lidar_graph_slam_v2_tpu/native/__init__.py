"""Native (C++) components, loaded via ctypes.

The reference's runtime is C++; the compute path here is JAX/XLA, and the
native pieces provide (a) honest optimized-CPU baselines for the benchmark
harness and (b) host-side hot utilities.  Built on demand with g++ -O3 and
cached next to the sources (the ``.so`` files are not committed).

A failed build (no g++, or a compile error) raises ``RuntimeError`` with
the compiler's message.  The Carmen log reader then falls back to its
pure-Python parser (io/carmen.py), so the SLAM pipeline needs no C++
toolchain; only the benchmark's CPU baseline does.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent


def _build(name: str, extra_flags=()) -> Path:
    src = _DIR / f"{name}.cpp"
    lib = _DIR / f"lib{name}.so"
    if not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime:
        cmd = [
            "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
            *extra_flags, "-o", str(lib), str(src),
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except FileNotFoundError:
            raise RuntimeError(
                f"cannot build {lib.name}: no g++ on PATH"
            ) from None
        except subprocess.CalledProcessError as e:
            raise RuntimeError(
                f"cannot build {lib.name}: {' '.join(cmd)} failed:\n"
                f"{e.stderr[-2000:]}"
            ) from None
    return lib


_csm = None


def csm_baseline():
    """ctypes handle to the CPU correlative-matching baseline."""
    global _csm
    if _csm is None:
        lib = ctypes.CDLL(str(_build("csm_baseline")))
        lib.precompute_coarse_map.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.correlative_search.restype = ctypes.c_double
        lib.correlative_search.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.POINTER(ctypes.c_int),
        ]
        _csm = lib
    return _csm


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


_carmen = None


def carmen_reader():
    """ctypes handle to the native Carmen log parser."""
    global _carmen
    if _carmen is None:
        lib = ctypes.CDLL(str(_build("carmen_reader")))
        lib.carmen_load.restype = ctypes.c_void_p
        lib.carmen_load.argtypes = [ctypes.c_char_p]
        lib.carmen_free.argtypes = [ctypes.c_void_p]
        for fn in ("carmen_n_odom", "carmen_n_scan", "carmen_total_ranges"):
            getattr(lib, fn).restype = ctypes.c_long
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        dptr = ctypes.POINTER(ctypes.c_double)
        for fn in ("carmen_export_odom", "carmen_export_scan_meta",
                   "carmen_export_ranges"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p, dptr]
        _carmen = lib
    return _carmen


def carmen_load_arrays(path: str):
    """Parse a Carmen log natively. Returns (odom[n,7], scan_meta[n,16],
    ranges[total]) float64 arrays, or raises OSError if unreadable."""
    lib = carmen_reader()
    h = lib.carmen_load(os.fsencode(path))
    if not h:
        raise OSError(f"cannot read Carmen log: {path}")
    try:
        dptr = ctypes.POINTER(ctypes.c_double)
        odom = np.empty((lib.carmen_n_odom(h), 7), np.float64)
        meta = np.empty((lib.carmen_n_scan(h), 16), np.float64)
        ranges = np.empty(lib.carmen_total_ranges(h), np.float64)
        if odom.size:
            lib.carmen_export_odom(h, odom.ctypes.data_as(dptr))
        if meta.size:
            lib.carmen_export_scan_meta(h, meta.ctypes.data_as(dptr))
        if ranges.size:
            lib.carmen_export_ranges(h, ranges.ctypes.data_as(dptr))
        return odom, meta, ranges
    finally:
        lib.carmen_free(h)


def cpu_precompute_coarse(prob: np.ndarray, win: int) -> np.ndarray:
    lib = csm_baseline()
    prob = np.ascontiguousarray(prob, np.float32)
    out = np.empty_like(prob)
    lib.precompute_coarse_map(_fptr(prob), _fptr(out), prob.shape[0],
                              prob.shape[1], win)
    return out


def cpu_correlative_search(
    fine, coarse, ranges, angles, sensor_pose, resolution, offset_xy,
    win_x, win_y, win_t, step_theta, low_res,
    score_thresh=0.0, known_thresh=0.0,
):
    lib = csm_baseline()
    fine = np.ascontiguousarray(fine, np.float32)
    coarse = np.ascontiguousarray(coarse, np.float32)
    ranges = np.ascontiguousarray(ranges, np.float32)
    angles = np.ascontiguousarray(angles, np.float32)
    best = (ctypes.c_int * 3)()
    score = lib.correlative_search(
        _fptr(fine), _fptr(coarse), fine.shape[0], fine.shape[1],
        _fptr(ranges), _fptr(angles), len(ranges),
        float(sensor_pose[0]), float(sensor_pose[1]), float(sensor_pose[2]),
        float(resolution), float(offset_xy[0]), float(offset_xy[1]),
        int(win_x), int(win_y), int(win_t), float(step_theta), int(low_res),
        float(score_thresh), float(known_thresh), best,
    )
    return np.array([best[0], best[1], best[2]]), float(score)
