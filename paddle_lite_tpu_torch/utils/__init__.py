"""Device discovery (``device_info``)."""
