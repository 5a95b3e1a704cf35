"""Synthetic RGB-D sequences, windowing and batching (numpy)."""
