"""Training of the port's LMs: AdamW with float32 state (``optimizer``),
checkpoints in the reference's on-disk layout (``checkpoint``), the
preemption guard and step timer (``fault``) and the loop (``train_loop``)."""
