"""Device parallelism: the flush window's device list and the sharded
merge step (`mesh`), and the window arenas (`arena`).

Port of the JAX package's `parallel/`.
"""
