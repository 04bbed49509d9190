"""Device ops of the port: plain torch, plus the hand-written CUDA kernels
under ``../csrc`` (built at first use by ``_build``)."""
