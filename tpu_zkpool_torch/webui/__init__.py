"""Browser demo UI (C26), the port of ``tpu_zkpool/webui``: the framework's
analogue of the reference's Next.js frontend (``demo-frontend/app/
components/shielded-pool-card.tsx``, ``page.tsx``; SURVEY.md §1 L6).

A stdlib ``http.server`` app serving a single-page UI plus the JSON API the
reference splits between its UI card and relayer routes: deposit (identity
keygen + RLWE encryption inline), relayed withdraw (audit-then-withdraw two
transactions), root-age/status display, audit history, and auditor Shamir
decryption. State persists through the storage module; the pool's Merkle
tree lives on the app's device (``cuda`` unless the caller names another),
so every deposit's and withdraw's sibling path comes from ``build_levels``
there.

Run: ``python -m tpu_zkpool_torch.webui --rlwe-dir DIR [--port 8642]
[--device cuda] [--prover groth16 --artifact PATH]``; ``write_rlwe_dir(DIR)``
writes a key directory, ``scripts/withdraw_acir.py`` a withdraw artifact.
"""

from tpu_zkpool_torch.webui.app import DemoApp, write_rlwe_dir
from tpu_zkpool_torch.webui.server import make_server, serve

__all__ = ["DemoApp", "make_server", "serve", "write_rlwe_dir"]
