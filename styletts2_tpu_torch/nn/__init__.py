"""Neural network modules (channels-last activations, torch state-dict keys)."""
