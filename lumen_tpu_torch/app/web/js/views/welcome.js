// Welcome view (reference: web-ui/src/views/Welcome).

import { api } from "../api.js";
import { wizard } from "../wizard.js";
import { el, toast } from "../ui.js";

export function renderWelcome(root) {
  const resume = wizard.state.preset || wizard.state.configGenerated;
  root.append(
    el("div", { class: "hero" }, [
      el("div", { class: "glyph" }, "◳"),
      el("h1", {}, "Welcome to lumen-tpu"),
      el(
        "p",
        {},
        "TPU-native photo-indexing inference: CLIP embeddings, face " +
          "detection and recognition, OCR, and VLM captioning behind one " +
          "gRPC hub. This wizard detects your TPU, generates a deployment " +
          "config, installs model weights, and launches the server."
      ),
    ]),
    el("div", { class: "feature-row" }, [
      feature("Detect", "TPU generation, slice size, HBM and peak FLOPs — with a recommended topology preset."),
      feature("Configure", "Per-service batch and bucket sizing from the preset; single YAML, validated live."),
      feature("Install", "Model weights downloaded and verified into the cache, with live progress."),
      feature("Serve", "The gRPC hub as a supervised subprocess with health checks and live logs."),
    ]),
    el("div", { class: "hero" }, [
      el("button", { class: "btn primary", id: "welcome-start" }, resume ? "Resume setup →" : "Get started →"),
      " ",
      resume ? el("button", { class: "btn ghost", id: "welcome-reset" }, "Start over") : "",
    ]),
    // Reference OpenPath / SessionHub entry: existing deployments go
    // through their own first-class views (views/openpath.js ->
    // views/sessionhub.js), not the setup stepper.
    el("div", { class: "card" }, [
      el("h3", {}, "Already have a config?"),
      el("div", { class: "muted" }, "Open an existing lumen-config.yaml — the session hub checks the deployment and routes to serve or install."),
      el("div", { class: "row" }, [
        el("button", { class: "btn", id: "welcome-open" }, "Open existing deployment →"),
      ]),
    ])
  );

  root.querySelector("#welcome-start").onclick = () => wizard.next();
  const resetBtn = root.querySelector("#welcome-reset");
  if (resetBtn) resetBtn.onclick = () => wizard.reset();
  root.querySelector("#welcome-open").onclick = () => wizard.goto("openpath");

  // connectivity check so a dead control plane is obvious immediately
  api.health().catch((e) => toast(`control plane: ${e.message}`, true));
}

function feature(title, text) {
  return el("div", { class: "card" }, [
    el("h3", {}, title),
    el("div", { class: "muted" }, text),
  ]);
}
