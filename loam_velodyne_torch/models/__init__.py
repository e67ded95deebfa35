"""The pipeline stages: odometry, mapping, fusion and the engine."""
