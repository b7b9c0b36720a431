"""The frozen work counts against hand-worked shapes, the peaks, and the
readers' arithmetic on a synthetic trace."""
from __future__ import annotations

import json
import math

import pytest
import torch

from dndmbench import harness, readers, trace, work
from dndmbench.reference import model as ref_model
from dndmbench.work import (call, decode_scores, dndm_update,
                            flash_attention, ssd_scan)


def test_peaks():
    assert work.PEAKS["flops_per_s"] == {"float32": 495e12,
                                         "bfloat16": 989e12}
    assert work.PEAKS["hbm_bytes_per_s"] == 3.35e12
    assert work.bound_seconds(495e12, 0.0) == 1.0
    assert work.bound_seconds(1.0, 3.35e12) == 1.0
    assert work.bound_seconds(989e12, 0.0, "bfloat16") == 1.0


def test_flash_attention_counts():
    # q kᵀ: 2 * (B 2 * H 3 * S² 16 * hd 8) = 1536; p v the same
    assert flash_attention.flops(2, 4, 3, 8) == 3072
    # q and o: 2*4*3*8 each; k and v: 2*4*1*8 each; 4 bytes
    assert flash_attention.nbytes(2, 4, 3, 1, 8) == 4 * (192 * 2 + 64 * 2)


def test_ssd_scan_counts():
    # B=1, S=4, H=1, P=2, N=3, L=2: 2 chunks.  C Bᵀ: 2 * 2*3/2 entries *
    # 2N ops = 2 * 3 * 6 = 36; M x: 2 * 3 * 2P = 24; C S and the state
    # update once each: 2 * 2*L*N*P = 48
    assert ssd_scan.flops(1, 4, 1, 2, 3, 2) == 36 + 24 + 48
    # x and y 8 each, dt 4, B and C 12 each (4 bytes); state 6 (f32)
    assert ssd_scan.nbytes(1, 4, 1, 2, 3) == 4 * (16 + 4 + 24) + 4 * 6


def test_decode_counts():
    assert dndm_update.nbytes(3, 10) == 3 * 10 * 8 + 40 + 36
    assert decode_scores.nbytes(3, 10) == 3 * 10 * 8 + 40 + 24
    assert dndm_update.flops(3, 10) == decode_scores.flops(3, 10) == 0


def test_text8_call_count_by_hand():
    c = ref_model.expand(json.loads(
        (harness.BENCH / "configs" / "dndm-text8.json").read_text())["model"])
    d, ff, V, L = 768, 3072, 28, 12
    per_token = 2 * (L * (4 * d * d + 3 * d * ff) + d * V)
    attn = L * 4 * 32 * 12 * 256 * 256 * 64
    assert call.flops(c, 32, 256) == per_token * 32 * 256 + attn \
        + 2 * 2 * d * d * 32


def test_zamba2_call_counts_both_directions_and_every_site():
    c = ref_model.expand(json.loads(
        (harness.BENCH / "configs" / "zamba2-2.7b.json").read_text())[
        "model"])
    one = dict(c, bidirectional=False)
    mamba = 54 * (2 * (2560 * (2 * 5120 + 128 + 80) + 5120 * 2560
                       + 4 * 5248) * 1024
                  + ssd_scan.flops(4, 256, 80, 64, 64, 128))
    assert call.flops(c, 4, 256) - call.flops(one, 4, 256) == mamba


def test_union_and_host_time():
    assert trace.union_ns([(0, 10), (5, 12), (20, 25)]) == 17
    t = trace.Trace([("k", 0, 10), ("k", 5, 7)], [("cudaLaunchKernel", 0,
                                                   500_000_000)],
                    wall_s=2.0, calls=4)
    assert t.busy_s() == 12e-9
    assert t.host_own_s() == pytest.approx(1.5)


def _ctx(**kw):
    doc = json.loads((harness.BENCH / "configs" / "dndm-text8.json")
                     .read_text())
    p = harness.parts(doc)
    mix = harness.traffic_doc("closed-32x256-t1000")
    return harness.Context("text8-batch", p.reference.expand(doc["model"]),
                           mix, torch.device("cpu"), p.work, **kw)


def test_roofline_reads_launches_times_bound_over_device_time():
    one = work.bound_seconds(flash_attention.flops(32, 256, 12, 64),
                             flash_attention.nbytes(32, 256, 12, 12, 64))
    ops = [("void flash_attention_kernel<float, 64>(...)", 0,
            int(4 * one * 1e9))] * 3 + [("gemm", 0, 1000)]
    ctx = _ctx(trace=trace.Trace(ops, [], wall_s=1.0, calls=1))
    flash = harness.metric_reader("flash_attention_roofline.batch")
    assert flash.read(ctx) == pytest.approx(25.0, rel=1e-4)
    assert harness.metric_reader("dndm_update_roofline").read(ctx) is None


def test_device_metrics_without_a_trace_read_nothing():
    ctx = _ctx()
    for name in ("flash_attention_roofline.batch", "dndm_update_roofline",
                 "device_idle_share.batch", "host_ms_per_call.batch",
                 "ssd_scan_roofline"):
        assert harness.metric_reader(name).read(ctx) is None


def test_mfu_is_window_work_over_peak():
    ctx = _ctx(window_s=2.0, calls=40)
    ops = call.flops(ctx.config, 32, 256) * 40
    assert readers.call_mfu(ctx) == pytest.approx(
        100 * ops / 2.0 / 495e12)
    assert readers.ms_per_call(ctx) == 50.0
    assert math.isclose(harness.percentile([1, 2, 3, 4, 5], 50), 3)
