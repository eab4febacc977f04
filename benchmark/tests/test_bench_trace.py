"""The trace reduction on a small hand-made chrome trace, and the import
guard's whole-name comparison."""

from __future__ import annotations

import pytest

from benchmark.lib import guard, trace


def X(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": args.pop("pid", 1), "tid": 1, "args": args}


def hand_trace():
    """A stretch of 100 us: two steps, the second with a fused_stats span;
    four launches (one inside fused_stats), their kernels and a copy on
    device 0; an idle gap of 30 us on the device while step 1's host code
    ran."""
    return [
        X("bench/stretch", "user_annotation", 1000, 100),
        X("bench/step", "user_annotation", 1000, 40),
        X("bench/step", "user_annotation", 1045, 50),
        X("bench/fused_stats", "user_annotation", 1060, 20),
        X("cudaLaunchKernel", "cuda_runtime", 1001, 1, correlation=1),
        X("cudaLaunchKernel", "cuda_runtime", 1002, 1, correlation=2),
        X("cudaMemcpyAsync", "cuda_runtime", 1046, 1, correlation=3),
        X("cudaLaunchKernel", "cuda_runtime", 1061, 1, correlation=4),
        X("cudaLaunchKernel", "cuda_runtime", 1090, 1, correlation=5),
        X("doy_quantile_kernel<4>", "kernel", 1005, 10, correlation=1,
          device=0, pid=0),
        X("elementwise_add", "kernel", 1015, 5, correlation=2, device=0,
          pid=0),
        X("Memcpy HtoD", "gpu_memcpy", 1050, 10, correlation=3, device=0,
          pid=0),
        X("reduce_sum", "kernel", 1062, 8, correlation=4, device=0, pid=0),
        X("roll", "kernel", 1091, 4, correlation=5, device=0, pid=0),
        # outside the stretch: left out
        X("late", "kernel", 1200, 50, correlation=9, device=0, pid=0),
    ]


def test_analyse_hand_trace():
    an = trace.analyse(hand_trace())
    assert an["window_s"] == pytest.approx(100e-6)
    assert an["busy_s"] == {"0": pytest.approx(37e-6)}
    assert an["launches"] == {"step": 4, "fused_stats": 1}
    assert an["launches_all"] == 4
    assert an["spans"]["step"] == [(0.0, pytest.approx(40e-6)),
                                   (pytest.approx(45e-6),
                                    pytest.approx(95e-6))]
    owner = {name: span for name, _, _, _, span in an["ops"]}
    assert owner == {"doy_quantile_kernel<4>": "step",
                     "elementwise_add": "step", "Memcpy HtoD": "step",
                     "reduce_sum": "fused_stats", "roll": "step"}
    # gaps: 1000-1005, 1020-1050 (30 us, inside step 1 then between
    # steps: its middle at 1035 falls in step 1), 1060-1062, 1070-1091,
    # 1095-1100
    assert an["gaps"][0] == (pytest.approx(30e-6), "step")
    assert an["gaps"][1] == (pytest.approx(21e-6), "step")
    b = trace.breakdown(an)
    assert b["device_ops"][0] == ["doy_quantile_kernel<4>",
                                  pytest.approx(10e-6)]
    assert len(b["device_ops"]) == 5 and len(b["idle_gaps"]) == 5


def test_analyse_needs_the_stretch():
    with pytest.raises(ValueError):
        trace.analyse(hand_trace()[1:])


def test_guard_tells_the_port_from_the_jax_package():
    assert guard.forbidden(["xmhw_tpu_torch", "xmhw_tpu_torch.core",
                            "numpy", "jaxtyping"]) == []
    assert guard.forbidden(["xmhw_tpu.core.pipeline", "jax._src"]) == [
        "jax", "xmhw_tpu"]
    assert guard.forbidden(["flax", "jaxlib.xla_client"]) == ["flax",
                                                              "jaxlib"]
