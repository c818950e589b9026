"""Host substrate (numpy, carried over from `repro.core`) and the
criticality labeling path in torch."""
