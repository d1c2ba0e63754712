"""Data: synthetic raw blobs, raw preprocessing, datasets, SR-dataset generation."""
