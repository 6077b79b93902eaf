"""Developer tools of the port."""
