"""Chip smoke for the PyTorch/CUDA port (yolov5m_tpu_torch) on one GPU.

Run from the repo root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile the two CUDA NMS kernels (suppress_bits, then
     greedy_sweep) from csrc/nms.cu;
  3. kernels against plain: the packed suppress matrix and the keep mask
     must equal the plain versions' exactly over K in {128, 512, 1024,
     2048}, bs in {1, 128} and the cases dense clusters, score ties, many
     classes, all-invalid, the alternating chain, and K not a multiple of
     32; each kernel's time per K;
  4. main path at full width: flagship YOLOv5m (first_out 48, nc 80, BN
     folded, bf16, channels_last) on 128 structured 640x640 uint8 frames,
     normalize -> model -> fused_detect (K 512); both kernels must have
     been launched, the plain backend must give identical results, and
     detections per image must reach 1.0; median images/s;
  5. server: the port's DetectionServer (bs 16, conf 0.25) answers 16
     non-square PPM frames from two pipelining clients, in order;
  6. the kernels line, then the last line {"ok": true, "device": ...}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# the CUDA NMS kernels' TPU counterpart (the function reaching pallas_call)
REPLACES = "yolov5m_tpu/ops/pallas/nms_kernel.py:55"
# H100 SXM published peaks (NVIDIA H100 datasheet): HBM bytes/s and
# float32 non-tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# f32 operations per IoU decision in nms.cu: 2x(min, max, sub, max) for
# the overlap, 1 mul, 3 add/sub for the union, 1 div, 2 compares
OPS_PER_PAIR = 15


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of fn() over reps runs, CUDA events each."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def pick_bound(n_bytes: float, ops: float) -> tuple:
    """(ms, "bytes" | "operations"): the larger of bytes over the HBM rate
    and operations over the f32 (non-tensor-core) rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bits_bound_ms(bs: int, k: int) -> tuple:
    """Phase 1 (suppress_bits): boxes f32 x4 and classes f32 read once, the
    packed S written once; one IoU decision for every pair j > i (S does
    not depend on valid, so every pair is needed)."""
    words = (k + 31) // 32
    return pick_bound(bs * k * (16 + 4) + bs * k * words * 4,
                      bs * k * (k - 1) / 2 * OPS_PER_PAIR)


def sweep_bound_ms(valid: torch.Tensor, keep: torch.Tensor) -> tuple:
    """Phase 2 (greedy_sweep): valid (u8) read and keep (u8) written once;
    of S only the rows of kept rows must be read (a removed or invalid row
    suppresses nothing), and each is one OR per word plus one decision per
    row."""
    bs, k = valid.shape
    words = (k + 31) // 32
    kept = float(keep.sum())
    return pick_bound(bs * k * 2 + kept * words * 4, kept * words + bs * k)


# -- phase 3: kernel against plain ------------------------------------------

def nms_case_rows(case: str, bs: int, k: int, seed: int) -> tuple:
    """(rows (bs, k, 6) [class, conf, cx, cy, w, h], conf gate, iou t)."""
    rng = np.random.default_rng(seed)
    if case == "chain":
        # box i overlaps only i-1 and i+1 (IoU .43), scores descending:
        # greedy keeps the evens, and the fixpoint needs ~k/2 rounds
        i = np.arange(k, dtype=np.float32)
        one = np.stack([np.zeros(k), 1.0 - i / (2 * k), 20.0 * i + 25.0,
                        np.full(k, 100.0), np.full(k, 50.0),
                        np.full(k, 50.0)], -1)
        return np.repeat(one[None], bs, 0).astype(np.float32), 0.01, 0.3
    nc = {"dense": 2, "ties": 3, "many": 80, "invalid": 5}[case]
    centers = rng.uniform(100, 540, (bs, 12, 2))
    pick = rng.integers(0, 12, (bs, k))
    cxy = np.take_along_axis(centers, pick[..., None], 1) + rng.normal(
        0, 12, (bs, k, 2))
    wh = rng.uniform(40, 120, (bs, k, 2))
    cls = rng.integers(0, nc, (bs, k))
    conf = rng.uniform(0, 1, (bs, k))
    if case == "ties":
        conf = rng.integers(1, 5, (bs, k)) / 5.0     # many exact ties
    if case == "invalid":
        conf = np.zeros((bs, k))
    rows = np.concatenate([cls[..., None], conf[..., None], cxy, wh], -1)
    return rows.astype(np.float32), 0.25, 0.5


def kernel_vs_plain(nms, nms_kernel) -> list:
    cases = [(case, k, bs) for k in (128, 512, 1024, 2048) for bs in (1, 128)
             for case in ("dense", "ties", "many", "invalid", "chain")]
    cases += [("dense", k, bs) for k in (1, 33, 500, 2047) for bs in (1, 128)]
    timings = []
    for n, (case, k, bs) in enumerate(cases):
        rows, conf_t, iou_t = nms_case_rows(case, bs, k, seed=n)
        rows = torch.from_numpy(rows).cuda()
        boxes, cls, _, valid = nms._prepare(rows, conf_t, k)
        boxes, cls, valid = (t.contiguous() for t in (boxes, cls, valid))
        bits = nms_kernel.suppress_bits_cuda(boxes, cls, iou_t)
        bits_p = nms_kernel.suppress_bits_plain(boxes, cls, iou_t)
        got = nms.suppress(boxes, cls, valid, iou_t, backend="cuda")
        want = nms.suppress(boxes, cls, valid, iou_t, backend="torch")
        torch.cuda.synchronize()
        bad_words = int((bits != bits_p).sum())
        bad = int((got != want).sum())
        log(f"kernel-vs-plain case={case} K={k} bs={bs} valid={int(valid.sum())}"
            f" kept={int(want.sum())} S-word mismatches={bad_words} "
            f"keep mismatches={bad}")
        if bad or bad_words:
            raise AssertionError(f"CUDA NMS disagrees with plain: {case} "
                                 f"K={k} bs={bs}: {bad_words} S words, "
                                 f"{bad} keep entries")
        if case == "dense" and bs == 128 and k in (128, 512, 1024, 2048):
            t = {"K": k, "bs": bs,
                 "ms": cuda_ms(lambda: nms.suppress(
                     boxes, cls, valid, iou_t, backend="cuda"), 20),
                 "bits_ms": cuda_ms(lambda: nms_kernel.suppress_bits_cuda(
                     boxes, cls, iou_t), 20),
                 "sweep_ms": cuda_ms(lambda: nms_kernel.greedy_sweep_cuda(
                     bits, valid), 20),
                 "plain_ms": cuda_ms(lambda: nms.suppress(
                     boxes, cls, valid, iou_t, backend="torch"), 3)}
            timings.append(t)
            log(f"nms timing K={k} bs={bs}: kernels {t['ms']:.4f} ms "
                f"(suppress_bits {t['bits_ms']:.4f} + greedy_sweep "
                f"{t['sweep_ms']:.4f}), plain {t['plain_ms']:.4f} ms, launches "
                f"so far {nms_kernel.bits_launches} / "
                f"{nms_kernel.sweep_launches}")
    return timings


# -- phase 4: main path -------------------------------------------------------

def main_path(card: str) -> dict:
    from yolov5m_tpu_torch.config import Config
    from yolov5m_tpu_torch.data.synthetic import synth_batch, to_uint8
    from yolov5m_tpu_torch.models.weights import load_flagship
    from yolov5m_tpu_torch.models.yolo import YOLOv5, normalized_anchors
    from yolov5m_tpu_torch.ops import nms
    from yolov5m_tpu_torch.ops.cuda import nms_kernel
    from yolov5m_tpu_torch.ops.postprocess import candidates, fused_detect
    from yolov5m_tpu_torch.ops.preprocess import normalize_uint8

    cfg = Config()
    bs, k = 128, cfg.topk_for_conf(0.25)
    kw = dict(conf_threshold=0.25, iou_threshold=cfg.nms_iou_thresh,
              max_detections=cfg.max_detections, pre_nms_topk=k)
    sd, sidecar = load_flagship(fold=True, device="cuda")
    model = YOLOv5(first_out=cfg.first_out, nc=cfg.nc, fused=True)
    model.load_state_dict(sd, strict=True)
    model = model.to(device="cuda", dtype=torch.bfloat16,
                      memory_format=torch.channels_last).eval()
    anchors = torch.from_numpy(normalized_anchors()).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    frames = [to_uint8(synth_batch(gen, bs, 640, cfg.nc)[0])
              for _ in range(3)]
    torch.cuda.synchronize()

    def run(x_u8, backend="auto"):
        preds = model(normalize_uint8(x_u8, torch.bfloat16))
        return preds, fused_detect(preds, anchors, backend=backend, **kw)

    # bf16 normalize on the card equals the CPU's for all 256 codes (the
    # CPU's is held equal to the JAX package's in the tests)
    codes = torch.arange(256, dtype=torch.uint8)
    if not torch.equal(normalize_uint8(codes.cuda(), torch.bfloat16).cpu(),
                       normalize_uint8(codes, torch.bfloat16)):
        raise AssertionError("bf16 normalize differs between card and CPU")

    with torch.inference_mode():
        nms_kernel.bits_launches = nms_kernel.sweep_launches = 0
        preds, (det, valid) = run(frames[0])
        times = []
        for r in range(2 + 9):                     # 2 warmup rounds
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(frames[r % len(frames)])[1][1].sum().item()
            if r >= 2:
                times.append(time.perf_counter() - t0)
        launches = {"suppress_bits": nms_kernel.bits_launches,
                    "greedy_sweep": nms_kernel.sweep_launches}
        if min(launches.values()) < 1:
            raise AssertionError(f"the main path did not launch both CUDA "
                                 f"NMS kernels: {launches}")

        det_p, valid_p = fused_detect(preds, anchors, backend="torch", **kw)
        if not (torch.equal(valid, valid_p) and torch.equal(det, det_p)):
            raise AssertionError("fused_detect: cuda and torch backends differ")
        if not torch.isfinite(det).all():
            raise AssertionError("non-finite detections")
        thresh = float(np.log(0.25 / 0.75))
        obj = torch.cat([p[..., 4].reshape(bs, -1) for p in preds], 1)
        survivors = float((obj.float() > thresh).sum(1).float().mean())
        dets = float(valid.sum(1).float().mean())
        ref = sidecar["density_at_conf_0.25"]["structured"]
        log(f"main path: gate survivors/image {survivors:.3f} (sidecar "
            f"{ref['gate_survivors_per_image']}), detections/image {dets:.3f}"
            f" (sidecar {ref['detections_per_image']})")
        if dets < 1.0:
            raise AssertionError(f"{dets} detections per image: the layout "
                                 "or weight bridge is broken")
        ips = bs / statistics.median(times)
        log(f"main path: {ips:.2f} images/s (median of {len(times)} rounds, "
            f"bs {bs}, 640x640 uint8 on device, normalize+model+fused_detect)"
            f" on {card}")

        # each kernel on the main path's own NMS input, against its plain
        # version on the same input
        iou_t = kw["iou_threshold"]
        boxes, cls, conf, cvalid = candidates(preds, anchors, (8, 16, 32),
                                              0.25, k)
        boxes, cls, cvalid = (t.contiguous() for t in (boxes, cls, cvalid))
        bits = nms_kernel.suppress_bits_cuda(boxes, cls, iou_t)
        bits_p = nms_kernel.suppress_bits_plain(boxes, cls, iou_t)
        got = nms_kernel.greedy_sweep_cuda(bits, cvalid)
        got_p = nms_kernel.greedy_sweep_plain(bits, cvalid)
        want = nms.suppress(boxes, cls, cvalid, iou_t, "torch")
        bit_err = (nms_kernel.unpack_rows(bits, k).int()
                   - nms_kernel.unpack_rows(bits_p, k).int()).abs()
        kernels = {
            "suppress_bits": {
                "mismatches": int(bit_err.sum()),
                "max_abs_err": float(bit_err.max()),
                "ms": cuda_ms(lambda: nms_kernel.suppress_bits_cuda(
                    boxes, cls, iou_t), 50),
                "plain_ms": cuda_ms(lambda: nms_kernel.suppress_bits_plain(
                    boxes, cls, iou_t), 5)},
            "greedy_sweep": {
                "mismatches": int((got != got_p).sum()),
                "max_abs_err": float((got.int() - got_p.int()).abs().max()),
                "ms": cuda_ms(lambda: nms_kernel.greedy_sweep_cuda(
                    bits, cvalid), 50),
                "plain_ms": cuda_ms(lambda: nms_kernel.greedy_sweep_plain(
                    bits, cvalid), 5)}}
        if any(v["mismatches"] for v in kernels.values()) \
                or not torch.equal(got, want):
            raise AssertionError(f"main-path NMS input: kernels differ from "
                                 f"plain: {kernels}")
        for name, bound in (("suppress_bits", bits_bound_ms(bs, k)),
                            ("greedy_sweep", sweep_bound_ms(cvalid, got))):
            kernels[name].update(launches=launches[name], bound_ms=bound[0],
                                 bound_by=bound[1])
        ms = kernels["suppress_bits"]["ms"] + kernels["greedy_sweep"]["ms"]
        log(f"main-path NMS bs={bs} K={k}: " + json.dumps(kernels)
            + f", valid/image {float(cvalid.sum(1).float().mean()):.3f}, "
            f"kept/image {float(got.sum(1).float().mean()):.3f}")

        # where a round's time goes: each stage alone on the same batch
        x = normalize_uint8(frames[0], torch.bfloat16)
        stages = {
            "normalize": cuda_ms(
                lambda: normalize_uint8(frames[0], torch.bfloat16), 10),
            "model": cuda_ms(lambda: model(x), 10),
            "gate_topk_decode": cuda_ms(lambda: candidates(
                preds, anchors, (8, 16, 32), 0.25, k), 10),
            "nms_kernels": ms,
            "compact": cuda_ms(lambda: nms._compact(
                boxes, cls, conf, got, cfg.max_detections), 10),
            "round": 1e3 * statistics.median(times),
        }
        log("main-path stages (ms, CUDA events, median): "
            + json.dumps({n: round(t, 4) for n, t in stages.items()}))
    return {"model": model, "kernels": kernels,
            "images_per_s": ips, "stages": stages,
            "detections_per_image": dets, "survivors_per_image": survivors}


# -- phase 5: server ------------------------------------------------------------

def serve_frames(model) -> dict:
    from yolov5m_tpu_torch.config import COCO_LABELS
    from yolov5m_tpu_torch.data.native import encode_ppm
    from yolov5m_tpu_torch.data.synthetic import synth_batch, to_uint8
    from yolov5m_tpu_torch.models.yolo import normalized_anchors
    from yolov5m_tpu_torch.ops.cuda import nms_kernel
    from yolov5m_tpu_torch.serving.server import (DetectionClient,
                                                  DetectionServer)

    gen = torch.Generator(device="cuda").manual_seed(1)
    scenes = to_uint8(synth_batch(gen, 16, 640, 80)[0]).cpu().numpy()
    # distinct heights identify each reply; 48x-x640 frames need no resize
    frames = [encode_ppm(scenes[i, :480 + 2 * i]) for i in range(16)]
    server = DetectionServer(model, normalized_anchors(), labels=COCO_LABELS,
                             batch_size=16, conf_threshold=0.25,
                             max_wait_ms=5.0)
    server.start()
    replies = [None, None]
    try:
        nms_kernel.bits_launches = nms_kernel.sweep_launches = 0

        def client(c):
            mine = list(range(c, 16, 2))
            with DetectionClient(port=server.port) as cl:
                for i in mine:                      # pipelined
                    cl.send(frames[i])
                replies[c] = [(i, cl.recv()) for i in mine]

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        launches = {"suppress_bits": nms_kernel.bits_launches,
                    "greedy_sweep": nms_kernel.sweep_launches}
    finally:
        server.stop()
    if any(t.is_alive() for t in threads) or None in replies:
        raise AssertionError("a client did not finish")
    n_det = 0
    for pairs in replies:
        for i, resp in pairs:
            if not resp.get("ok") or resp["height"] != 480 + 2 * i \
                    or resp["width"] != 640:
                raise AssertionError(f"reply for frame {i} wrong or out of "
                                     f"order: {str(resp)[:200]}")
            n_det += len(resp["detections"])
    log(f"server: 16 frames from 2 clients answered in order, {n_det} "
        f"detections, kernel launches while serving {launches}")
    if n_det < 1:
        raise AssertionError("the server found no detection in 16 scenes")
    if min(launches.values()) < 1:
        raise AssertionError(f"the server did not launch both CUDA NMS "
                             f"kernels: {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from yolov5m_tpu_torch.ops import nms
    from yolov5m_tpu_torch.ops.cuda import nms_kernel

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(card)

    t0 = time.perf_counter()
    nms_kernel.build()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
        f"{nms_kernel.build_seconds})")
    log(nms_kernel.build_log.strip())

    timings = kernel_vs_plain(nms, nms_kernel)
    main = main_path(card)
    serve_launches = serve_frames(main["model"])

    kernels = []
    for name, note in (("suppress_bits", "phase 1: packed suppress matrix"),
                       ("greedy_sweep", "phase 2: greedy keep mask")):
        k = main["kernels"][name]
        kernels.append({
            "name": f"nms_{name}", "route": "cuda",
            "source": "yolov5m_tpu_torch/csrc/nms.cu", "replaces": REPLACES,
            "what": note, "launches": k["launches"],
            "serve_launches": serve_launches[name],
            "mismatches": k["mismatches"], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None,
            "per_k": [{"K": t["K"], "bs": t["bs"],
                       "ms": t["bits_ms" if name == "suppress_bits"
                               else "sweep_ms"]} for t in timings]})
    log(f"{card}: main path {main['images_per_s']:.2f} images/s, "
        f"{main['detections_per_image']:.3f} detections/image")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
