"""Runtime integration of the control plane with the jobs it governs,
and the fault-tolerant training loop."""
