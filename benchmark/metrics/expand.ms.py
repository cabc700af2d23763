"""Device ms of the model's expand and boundary on a frontier batch of the
cell's width (layers.LayerProbe)."""


def read(run):
    return run.probe.expand_ms if run.probe is not None else None
