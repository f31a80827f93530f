"""PyTorch/CUDA port of the yolov5m_tpu framework (the JAX package stays the reference)."""

__version__ = "0.1.0"
