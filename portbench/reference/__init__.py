"""The plain reference that decides `correct`: a frozen copy of the
port's NumPy oracle (mtr_tpu_torch/oracle with its records, chaining,
encoding and MT19937 modules), reproducing mTR byte for byte, with the
native-engine shortcuts taken out, the redundant-range scan vectorised,
the k sweep's wrap-around DP fills batched, and the DI's floating-point
precision a parameter (for the control).  It imports NumPy and nothing of
the port, and nothing imports it but portbench."""
