"""PyTorch/CUDA port of ekuiper_tpu's streaming-SQL engine.

Entry points: `ekuiper_tpu_torch.planner.fused.plan_fused_rule` (windowed
aggregates on the fused node), `ekuiper_tpu_torch.planner.rulegroup.
plan_rule_group` (rule groups) and `ekuiper_tpu_torch.planner.planner.
plan_host_rule` (the relational tier: interval joins, lag, window
functions).
"""
