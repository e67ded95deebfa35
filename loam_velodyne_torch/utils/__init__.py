"""Pose math and state conversion."""
