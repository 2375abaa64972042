"""The plain reference of the swarm round: plain PyTorch in float32,
importing nothing of the program (``repro_torch``) and nothing of the
JAX package. One module a model family (today ``dense_lm``),
``swarm`` for the round (local steps and adam, eval, the coordinator,
Eq. 2), and ``precision`` for the lower precisions of the control."""
