"""Training: losses, state, the train step and the SpC / SpC-Retrain loops."""
