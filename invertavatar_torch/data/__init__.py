"""Dataset readers of the preprocessed-dataset layout."""
