"""repro_torch: the dataframe engine of *Towards Scalable Dataframe Systems*
(Petersohn et al., 2020) on PyTorch and CUDA, with hand-written Hopper
(sm_90a) kernels for its hot operators.  A port of the JAX package
``repro`` that imports nothing from it; entry points run on CUDA unless the
caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"
