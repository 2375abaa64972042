"""Operations and bytes of the program's work, counted from shapes: the
model FLOPs of a round (``mfu_pct``) and the bytes of a kernel's least
time (``*_roofline_pct``). A configuration names its FLOP module in its
``flops`` key. Each count equals what ``torch.utils.flop_counter``
counts over the plain reference (tested at small sizes)."""
