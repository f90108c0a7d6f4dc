"""The distributed layer of the port: the ambient ``ShardContext``
(``context``), the sequence- and vocabulary-sharded ⊕ merges
(``decode_attention``), gradient compression and its int8 wire form
(``compression``), and the placement rules (``sharding``)."""
