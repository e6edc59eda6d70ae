"""Command-line tools (SURVEY.md §1 L7): the gst-launch-1.0 and
gst-inspect-1.0 analogues, run as `python -m gstpu_torch.tools.launch`
and `python -m gstpu_torch.tools.inspect`.

The port's copy of gstpu/tools/ with its launch and inspect tools;
gstpu's docs-cache generator and signalling server are not ported yet.
"""
