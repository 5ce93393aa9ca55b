"""Neural-network modules of the port (conformer encoder, predictor, joint)."""
