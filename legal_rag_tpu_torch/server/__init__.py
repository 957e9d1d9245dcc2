"""Serving layer: HTTP app + response-shaping modules (timeline
anchors, confidence, answer units, sentence attribution, source
fetching) — the capability surface the reference's tests specify but
its snapshot never shipped (SURVEY.md §2.4 'ghost components')."""
