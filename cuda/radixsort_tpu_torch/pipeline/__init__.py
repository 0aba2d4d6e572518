"""Query layer: the logical plan (plan.py) and the hand-fused filter ->
join query (query.py)."""
