"""Sweep sources."""
