"""The training data pipeline: a seeded synthetic token stream and its
host-side prefetcher."""
