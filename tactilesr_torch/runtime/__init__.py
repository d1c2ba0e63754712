"""Runtime: device selection and checkpoint bundles."""
