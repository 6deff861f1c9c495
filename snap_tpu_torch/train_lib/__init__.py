"""Training: learning-rate schedule, optimizer and the train step."""
