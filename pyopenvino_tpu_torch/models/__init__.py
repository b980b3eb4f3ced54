"""IR topologies the port ships (``resnet18.xml`` and ``mobilenet_v2.xml``,
224×224, 1000 classes) with weight synthesis for them (``synth.py``), and
seeded images of shapes with their boxes for the SSD detector
(``shapes.py``)."""
