"""Runtime integration of the control plane with the jobs it governs."""
