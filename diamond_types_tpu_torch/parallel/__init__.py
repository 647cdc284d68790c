"""Device parallelism for the serve tier: the flush window's device list
(`mesh`) and its window arenas (`arena`).

Port of the serve half of the JAX package's `parallel/`. The graph half
(`sharded_replay`, `pad_edges`, `sharded_reach_fixed_point`,
`multichip_merge_step`) is not ported yet.
"""
