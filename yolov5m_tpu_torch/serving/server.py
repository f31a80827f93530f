"""Batching detection server: port of ``yolov5m_tpu/serving/server.py``.

One device, with ``dp_devices`` one replica a device
(``parallel/infer.py``), or with ``tp_devices`` the model's channels split
over a grid (``parallel/tp.py``). The pieces:

  * host data plane: one reader thread per connection decodes the frame
    (``data/native.py:decode_image``, as the JAX server decodes it: JPEG
    through the port's decoder as libjpeg-turbo 2.1 decodes it, and one
    that refuses as Pillow does, CMYK, YCCK and lossless included; PNG,
    BMP, GIF, WebP, PNM and TIFF that is uncompressed, LZW, deflate or
    PackBits as Pillow decodes them) and letterboxes it
    on the host in the C library;
  * device data plane: uint8 batches of a fixed size go to the device
    through two pinned ping-pong buffers; normalize, the model and
    ``fused_detect`` (the CUDA NMS kernel on the card) run there. Short
    batches are padded;
  * batching: one batcher thread collects up to ``batch_size`` requests,
    waiting at most ``max_wait_ms`` after the first;
  * depth-1 pipelining: batch i+1 is dispatched before batch i's results
    are fetched, so host reply work overlaps device time. Results come
    back through one ``.cpu()`` per batch in ``_respond``.

Wire protocol (length-prefixed, as the JAX server's):
  request  = uint32_be length | image bytes; length 0 closes the connection.
  response = uint32_be length | UTF-8 JSON:
             {"ok": true, "width": W, "height": H,
              "detections": [{"class_id": i, "label": str,
                              "confidence": p, "box": [x1, y1, x2, y2]}]}
             (box in original-image pixels) or {"ok": false, "error": "..."}.
Replies come back in request order on each connection.
"""

from __future__ import annotations

import json
import queue
import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from yolov5m_tpu_torch.config import Config
from yolov5m_tpu_torch.data.native import decode_image, letterbox
from yolov5m_tpu_torch.ops.boxes import unletterbox_boxes_np
from yolov5m_tpu_torch.ops.cuda import nms_kernel
from yolov5m_tpu_torch.ops.postprocess import fused_detect
from yolov5m_tpu_torch.ops.preprocess import normalize_uint8

_HDR = struct.Struct(">I")
_MAX_REQUEST = 64 * 1024 * 1024  # reject absurd frames early
_STOP = object()                 # batcher shutdown sentinel


def _read_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """None on EOF or any socket error: a client reset reads as a clean
    disconnect."""
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


@dataclass
class _Pending:
    conn: socket.socket
    wlock: threading.Lock
    image: Optional[np.ndarray] = None           # letterboxed uint8
    geom: Optional[Tuple] = None                 # (ratio, (dw, dh), orig_hw)
    error: Optional[str] = None
    payload: dict = field(default_factory=dict)


class DetectionServer:
    """Batching TCP detection server around a (BN-folded) YOLOv5 module.

    ``model`` is an ``nn.Module`` already on its device, taking NHWC input;
    its parameters' dtype is the compute dtype (bf16 for serving). Use
    ``with DetectionServer(...) as srv:`` or start()/stop().

    dp_devices: a device list (the JAX ``dp_mesh``); each device batch is
    then served by ``parallel/infer.py``'s replicas, one shard a device,
    behind the one socket. batch_size must be a multiple of its length;
    the staging buffers go to its first device.

    tp_devices: a (data, model) grid of devices, rows of a 2-D list, or
    one row for the model axis alone (the JAX ``tp_mesh``): each batch is
    served by ``parallel/tp.py``'s channel-split model, float or int8
    (``quant`` "chain" or "block"), the uint8 frames normalized on the
    grid. batch_size must be a multiple of the number
    of rows; exclusive with dp_devices, since TP composes with data
    parallelism on its own grid."""

    def __init__(self, model: torch.nn.Module, anchors_norm,
                 labels: Optional[Sequence[str]] = None,
                 image_size: int = 640,
                 conf_threshold: float = 0.25,
                 iou_threshold: float = 0.45,
                 max_detections: int = 300,
                 pre_nms_topk: Optional[int] = None,
                 batch_size: int = 16,
                 max_wait_ms: float = 5.0,
                 overlap: bool = True,
                 dp_devices: Optional[Sequence] = None,
                 tp_devices: Optional[Sequence] = None,
                 host: str = "127.0.0.1",
                 port: int = 0):
        param = next(model.parameters())
        self.model = model.eval()
        if dp_devices and tp_devices:
            raise ValueError("dp_devices and tp_devices are mutually "
                             "exclusive: TP composes with data parallelism "
                             "on its own grid's rows")
        tp_mesh = None
        if tp_devices:
            from yolov5m_tpu_torch.parallel.mesh import Mesh
            two_d = isinstance(tp_devices[0], (list, tuple))
            tp_mesh = Mesh(tp_devices, ("data", "model") if two_d
                           else ("model",))
        self.device = (torch.device(dp_devices[0]) if dp_devices
                       else tp_mesh.devices.flat[0] if tp_mesh is not None
                       else param.device)
        self.compute_dtype = param.dtype
        self.anchors = torch.as_tensor(anchors_norm, dtype=torch.float32,
                                       device=self.device)
        self.labels = list(labels) if labels else None
        self.image_size = int(image_size)
        self.batch_size = int(batch_size)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.overlap = bool(overlap)
        self._det_kw = dict(
            conf_threshold=conf_threshold, iou_threshold=iou_threshold,
            max_detections=max_detections,
            pre_nms_topk=(Config().topk_for_conf(conf_threshold)
                          if pre_nms_topk is None else pre_nms_topk))
        # refuse at once what the NMS kernel would refuse on every batch
        n_rows = 3 * sum((self.image_size // st) ** 2 for st in (8, 16, 32))
        k = min(self._det_kw["pre_nms_topk"], n_rows)
        if self.device.type == "cuda" and k > nms_kernel.MAX_K:
            raise ValueError(f"pre_nms_topk gives K={k}, above the CUDA NMS "
                             f"kernel's cap {nms_kernel.MAX_K}")
        self._dp_infer = self._tp_infer = None
        if dp_devices:
            if self.batch_size % len(dp_devices):
                raise ValueError(f"batch_size {batch_size} must be a multiple "
                                 f"of the {len(dp_devices)} dp_devices")
            from yolov5m_tpu_torch.parallel.infer import make_dp_infer_fn
            self._dp_infer = make_dp_infer_fn(model, anchors_norm, dp_devices,
                                              **self._det_kw)
        if tp_mesh is not None:
            n_data = tp_mesh.shape.get("data", 1)
            if self.batch_size % n_data:
                raise ValueError(f"batch_size {batch_size} must be a multiple "
                                 f"of the tp_devices' {n_data} rows")
            from yolov5m_tpu_torch.parallel.tp import make_tp_infer_fn
            # the frames' normalize runs inside, on the grid
            self._tp_infer = make_tp_infer_fn(
                model, anchors_norm, tp_mesh, uint8_ingress=True,
                **self._det_kw)
        self._host, self._port = host, int(port)
        # a first start with port=0 must not pin the assigned ephemeral
        # port for a restart (it can linger in TIME_WAIT)
        self._req_port = int(port)
        # bounded: a full queue blocks the readers, which stops them
        # reading their sockets (TCP backpressure instead of host OOM)
        self._queue: "queue.Queue" = queue.Queue(
            maxsize=max(4 * batch_size, 64))
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._batcher: Optional[threading.Thread] = None
        self._listener: Optional[socket.socket] = None
        s = self.image_size
        pin = self.device.type == "cuda"
        # two staging buffers: with depth-1 pipelining at most two batches
        # are in flight, and _respond's sync on batch i finishes its copy
        # before batch i+2 rewrites the buffer
        self._bufs = [torch.zeros((self.batch_size, s, s, 3),
                                  dtype=torch.uint8, pin_memory=pin)
                      for _ in range(2)]
        self._buf_i = 0

    # -- lifecycle -----------------------------------------------------

    def start(self, warmup: bool = True) -> "DetectionServer":
        if self._batcher is not None and self._batcher.is_alive():
            # a batcher that outlived stop() still owns the queue; a second
            # one would break the in-order reply protocol
            raise RuntimeError("a previous batcher thread is still running; "
                               "stop() it before start()")
        self._stop.clear()
        while True:                  # drain a sentinel a stop() left behind
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._threads = []
        if warmup:
            x = torch.zeros((self.batch_size, self.image_size,
                             self.image_size, 3), dtype=torch.uint8,
                            device=self.device)
            self._infer(x).cpu()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self._host, self._req_port))
        self._listener.listen(128)
        self._port = self._listener.getsockname()[1]
        for fn in (self._accept_loop, self._batch_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)
        self._batcher = self._threads[-1]
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                # shutdown wakes the thread blocked in accept(); close alone
                # does not on Linux
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._listener.close()
        try:
            self._queue.put_nowait(_STOP)  # wake an idle batcher
        except queue.Full:
            pass                           # not idle: it checks the flag
        for t in self._threads:
            t.join(timeout=5)
        if self._batcher is not None and self._batcher.is_alive():
            # a stalled device can hold the batcher past the join; draining
            # now would answer queued requests out of order
            print("WARNING: batcher still busy at stop(); queued requests "
                  "left to it", flush=True)
            return
        # fail what is still queued, in two passes: the grace outlasts
        # _enqueue's put timeout, so a reader blocked in put() is caught
        for grace in (0.0, 0.3):
            if grace:
                time.sleep(grace)
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is _STOP:
                    continue
                self._send(item.conn, item.wlock,
                           {"ok": False, "error": "server stopped"})

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    @property
    def port(self) -> int:
        return self._port

    # -- host data plane ------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                if self._stop.is_set():
                    return  # listener closed by stop()
                time.sleep(0.05)   # transient (EMFILE, ECONNABORTED)
                continue
            threading.Thread(target=self._reader_loop, args=(conn,),
                             daemon=True).start()

    def _enqueue(self, item: _Pending) -> bool:
        """Blocking put that stays responsive to stop(). Returns False if
        the server stopped meanwhile."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    def _reader_loop(self, conn: socket.socket) -> None:
        """Read frames, decode and letterbox them, enqueue."""
        wlock = threading.Lock()
        with conn:
            while not self._stop.is_set():
                hdr = _read_exact(conn, _HDR.size)
                if hdr is None:
                    return
                (n,) = _HDR.unpack(hdr)
                if n == 0:
                    return  # graceful close
                item = _Pending(conn, wlock)
                if n > _MAX_REQUEST:
                    # the error rides the FIFO like any reply; drain the
                    # payload so the stream stays framed
                    item.error = f"frame too large ({n} bytes)"
                    left = n
                    while left > 0:
                        try:
                            chunk = conn.recv(min(left, 1 << 20))
                        except OSError:
                            chunk = b""
                        if not chunk:
                            self._enqueue(item)
                            return
                        left -= len(chunk)
                    if not self._enqueue(item):
                        return
                    continue
                data = _read_exact(conn, n)
                if data is None:
                    return
                img = decode_image(data)
                if img is None:
                    item.error = "undecodable image"
                else:
                    s = self.image_size
                    boxed, ratio, (dw, dh) = letterbox(img, (s, s))
                    item.image = boxed
                    item.geom = (ratio, (dw, dh), img.shape[:2])
                if not self._enqueue(item):
                    return

    # -- device data plane ----------------------------------------------

    def _infer(self, x_u8: torch.Tensor) -> torch.Tensor:
        """(bs, s, s, 3) uint8 on the device -> (bs, max_det, 7) rows
        [class, conf, x1, y1, x2, y2, valid], one tensor so that one copy
        brings a batch back."""
        with torch.inference_mode():
            grid_infer = self._dp_infer or self._tp_infer
            if grid_infer is not None:
                det, valid = grid_infer(x_u8)
            else:
                x = normalize_uint8(x_u8, self.compute_dtype)
                det, valid = fused_detect(self.model(x), self.anchors,
                                          **self._det_kw)
            return torch.cat([det, valid[..., None].float()], -1)

    def _batch_loop(self) -> None:
        """Depth-1 software pipeline: batch i+1 is collected and dispatched
        before batch i's results are fetched. With no waiting traffic the
        in-flight batch is flushed at once."""
        inflight = None
        while not self._stop.is_set():
            if inflight is None:
                seed = self._queue.get()           # idle: block for traffic
            else:
                try:
                    seed = self._queue.get_nowait()
                except queue.Empty:
                    self._respond(inflight)        # no traffic: flush i
                    inflight = None
                    continue
            if seed is _STOP:
                break
            nxt = self._dispatch(self._gather(seed))
            if inflight is not None:
                self._respond(inflight)            # device already runs nxt
            if self.overlap:
                inflight = nxt
            else:
                self._respond(nxt)
        if inflight is not None:
            self._respond(inflight)

    def _gather(self, first: _Pending) -> List[_Pending]:
        """Up to batch_size requests, waiting at most max_wait_ms after the
        first."""
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.batch_size:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                item = self._queue.get(timeout=timeout)
            except queue.Empty:
                break
            if item is _STOP:
                self._stop.set()  # finish this batch, then exit the loop
                break
            batch.append(item)
        return batch

    def _dispatch(self, batch: List[_Pending]):
        """Queue one device batch without synchronising; returns
        (batch, todo, result tensor on the device or None)."""
        todo = [b for b in batch if b.error is None]
        out = None
        if todo:
            try:
                buf = self._bufs[self._buf_i]
                self._buf_i ^= 1
                # padding rows keep stale frames; their outputs are unread
                for i, item in enumerate(todo):
                    buf[i] = torch.from_numpy(item.image)
                x = buf.to(self.device, non_blocking=True)
                out = self._infer(x)
            except Exception as e:  # keep the batcher alive: fail the batch
                for item in todo:
                    item.error = f"inference dispatch failed: {e}"
                todo, out = [], None
        return batch, todo, out

    def _respond(self, inflight) -> None:
        """Fetch a dispatched batch (the only device sync) and answer every
        request in arrival order."""
        batch, todo, out = inflight
        if todo:
            try:
                res = out.cpu().numpy()
                for i, item in enumerate(todo):
                    rows = res[i][res[i][:, 6] > 0.5, :6]
                    item.payload = self._to_payload(rows, item.geom)
            except Exception as e:  # keep the batcher alive
                for item in todo:
                    item.error = f"inference failed: {e}"
        for item in batch:
            if item.error is not None:
                item.payload = {"ok": False, "error": item.error}
            self._send(item.conn, item.wlock, item.payload)

    def _to_payload(self, rows: np.ndarray, geom) -> dict:
        ratio, (dw, dh), orig_hw = geom
        dets = []
        if len(rows):
            boxes = unletterbox_boxes_np(rows[:, 2:6], ratio, (dw, dh),
                                         orig_hw)
            for r, b in zip(rows, boxes):
                cid = int(r[0])
                label = (self.labels[cid]
                         if self.labels and cid < len(self.labels) else str(cid))
                dets.append({"class_id": cid, "label": label,
                             "confidence": round(float(r[1]), 5),
                             "box": [round(float(v), 2) for v in b]})
        return {"ok": True, "width": int(orig_hw[1]),
                "height": int(orig_hw[0]), "detections": dets}

    @staticmethod
    def _send(conn: socket.socket, wlock: threading.Lock, payload: dict) -> None:
        data = json.dumps(payload).encode()
        try:
            with wlock:
                conn.sendall(_HDR.pack(len(data)) + data)
        except OSError:
            pass  # client went away


class DetectionClient:
    """Minimal client for DetectionServer's length-prefixed protocol."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 timeout: float = 60.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)

    def detect(self, image_bytes: bytes) -> dict:
        self.send(image_bytes)
        return self.recv()

    def send(self, image_bytes: bytes) -> None:
        """Send one request without waiting; replies come in send order."""
        self._sock.sendall(_HDR.pack(len(image_bytes)) + image_bytes)

    def recv(self) -> dict:
        hdr = _read_exact(self._sock, _HDR.size)
        if hdr is None:
            raise ConnectionError("server closed the connection")
        (n,) = _HDR.unpack(hdr)
        data = _read_exact(self._sock, n)
        if data is None:
            raise ConnectionError("truncated response")
        return json.loads(data.decode())

    def close(self) -> None:
        try:
            self._sock.sendall(_HDR.pack(0))
        except OSError:
            pass
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
