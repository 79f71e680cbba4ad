"""Device-side compute: constraint residuals, the fleet planner and the
fused fleet kernel with its plain PyTorch version."""
