"""IR topologies the port ships (``resnet18.xml`` and ``mobilenet_v2.xml``,
224×224, 1000 classes) and weight synthesis for them (``synth.py``)."""
