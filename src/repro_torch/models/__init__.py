"""The language-model stack (port of ``repro.models``)."""
