// OpenPath view (reference: web-ui/src/views/OpenPath.tsx): enter the
// path of an existing deployment config, validate it against the control
// plane, then hand off to the SessionHub view. A first-class route
// outside the linear setup stepper, exactly like the reference's /open.

import { api } from "../api.js";
import { wizard } from "../wizard.js";
import { el, toast } from "../ui.js";

export function renderOpenPath(root) {
  root.append(
    el("div", { class: "hero" }, [
      el("h1", {}, "Open existing deployment"),
      el(
        "p",
        {},
        "Point at a lumen-config.yaml from a previous setup. The config " +
          "is validated and the session hub shows whether the deployment " +
          "can start as-is or needs the installer."
      ),
    ]),
    el("div", { class: "card" }, [
      el("h3", {}, "Config path"),
      el("div", { class: "row" }, [
        el("input", {
          id: "open-path",
          class: "input",
          placeholder: "/path/to/lumen-config.yaml",
          value: wizard.state.openPath || "",
          style: "flex:1",
        }),
        el("button", { class: "btn primary", id: "open-validate" }, "Validate →"),
      ]),
      el("div", { id: "open-result" }),
    ])
  );

  const input = root.querySelector("#open-path");
  const resultBox = root.querySelector("#open-result");
  const validate = async () => {
    const path = input.value.trim();
    if (!path) {
      resultBox.replaceChildren(el("p", { class: "err-note" }, "enter a config path"));
      return;
    }
    resultBox.replaceChildren(el("p", { class: "muted" }, "validating…"));
    try {
      const out = await api.configLoad(path);
      if (!root.isConnected) return;
      // Mark prior steps complete so stepper gating allows jumps the hub
      // recommends; the placeholder preset is never used for generation.
      wizard.update({
        preset: wizard.state.preset || "(existing config)",
        configGenerated: true,
        configPath: out.path,
        openPath: path,
      });
      resultBox.replaceChildren(
        el("p", { class: "ok-note" }, `✓ valid config (services: ${out.services.join(", ")})`)
      );
      wizard.goto("sessionhub");
    } catch (e) {
      if (!root.isConnected) return;
      resultBox.replaceChildren(el("p", { class: "err-note" }, `✕ ${e.message}`));
    }
  };
  root.querySelector("#open-validate").onclick = validate;
  input.onkeydown = (ev) => {
    if (ev.key === "Enter") validate();
  };

  api.health().catch((e) => toast(`control plane: ${e.message}`, true));
}
