"""The benchmark's harness: the cell's files found by name (:mod:`.spec`),
one run of a cell (:mod:`.cell`), the traced slice (:mod:`.trace`), the
comparison that decides ``correct`` (:mod:`.compare`) and the card
(:mod:`.card`)."""
