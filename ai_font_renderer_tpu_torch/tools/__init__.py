"""The port's tools, each ``python -m ai_font_renderer_tpu_torch.tools.<name>``:
the measurement scripts of the root tools/ on the card (ab_kernel_micro,
K9's home; profile_train, ab_profiles, trace_step, roofline_bwd, ab_fused,
ab_fused_attention, bench_inference, bench_batch_sweep, bench_serve,
bench_neural_render), the mesh's dry run and the attention probes."""
