"""Training: the e4e inversion stage (losses, optimizer, step, driver)."""
