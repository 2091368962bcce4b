"""One module per mode of the port."""
