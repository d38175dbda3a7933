"""PyTorch/CUDA port of ekuiper_tpu's streaming-SQL window aggregation.

Entry point: `ekuiper_tpu_torch.planner.fused.plan_fused_rule`.
"""
