"""Synthetic data pipeline of the port."""
