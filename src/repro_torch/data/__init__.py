"""The training data: the seeded Markov task (`data.pipeline`)."""
