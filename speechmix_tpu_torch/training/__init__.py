"""Training of the port: freezing masks and the deterministic train step."""
