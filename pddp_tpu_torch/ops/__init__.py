"""The port's CUDA kernels: K1 (``backward_kernel``) and K2
(``fused_rollout``). Nothing is built or loaded at import."""
