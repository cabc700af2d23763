"""Host-side core types of the port: properties, finish policies, paths, reports."""
