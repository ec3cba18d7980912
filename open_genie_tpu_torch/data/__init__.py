"""Data sources and the batch loader of the port."""
