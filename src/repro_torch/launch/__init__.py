"""Launch tools of the port: the serving driver."""
