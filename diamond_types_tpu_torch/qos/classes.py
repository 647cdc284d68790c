"""Per-request QoS class names, as the admission queue needs them.

The part of the JAX package's `qos/classes.py` that `serve/admission.py`
reads: the three classes in priority order (a coalescing re-submit keeps
the more urgent one). The class contracts and the controller are not
ported yet.
"""

# canonical class names, in priority order (smaller index = more urgent)
QOS_CLASSES = ("interactive", "bulk", "catchup")

QOS_PRIORITY = {name: i for i, name in enumerate(QOS_CLASSES)}
