"""Training: target assignment, the solver, the multi-task loss and the train step."""
