"""The port's CUDA kernels: K1 (``backward_kernel``), K2 stage (a)
(``fused_rollout``) and stage (d) with its fragment entries
(``fused_bnn_rollout``). Nothing is built or loaded at import."""
