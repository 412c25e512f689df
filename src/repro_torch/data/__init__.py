"""Synthetic federated datasets."""
