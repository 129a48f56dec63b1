// UserManagement.tsx (625 LoC): admin-only user administration — role
// stat tiles, search + role filter, inline role/tier/active editing with
// self-protection, delete-with-confirm modal, create-user modal with
// password visibility toggle.
import {api, h, main, esc, when, toast, USER} from "/static/app.js";

const ROLE_ICON = {admin: "🛡", researcher: "🔬", rater: "👁"};
const TIER_STYLE = {gold: "color:#d4a017", silver: "color:#9aa4af",
                    bronze: "color:#b0713c"};

export default async function UserManagement() {
  if (!USER || USER.role !== "admin") {
    return main.append(h(`<div class="panel" style="text-align:center;
        padding:40px"><h2>Access denied</h2>
      <div class="dim">Only administrators can access this page.</div>
      </div>`));
  }
  let users;
  try { users = await api("/api/auth/users"); }
  catch (e) {
    return main.append(h(`<div class="panel">${esc(e.message)}</div>`));
  }

  const nRole = (r) => users.filter(u => u.role === r).length;
  main.append(h(`<div class="panel"><h2>User management
      <span class="dim">users, roles and permissions</span>
      <button class="action" id="um-new">+ new user</button></h2>
    <div class="grid" style="grid-template-columns:repeat(4,1fr)">
      <div class="panel" style="text-align:center">
        <div class="stat">${users.length}</div>
        <div class="dim">total users</div></div>
      <div class="panel" style="text-align:center">
        <div class="stat">${ROLE_ICON.admin} ${nRole("admin")}</div>
        <div class="dim">admins</div></div>
      <div class="panel" style="text-align:center">
        <div class="stat">${ROLE_ICON.researcher} ${nRole("researcher")}</div>
        <div class="dim">researchers</div></div>
      <div class="panel" style="text-align:center">
        <div class="stat">${ROLE_ICON.rater} ${nRole("rater")}</div>
        <div class="dim">raters</div></div></div>
    <div class="row" style="margin:8px 0">
      <input id="um-search" placeholder="search by username or email…"
        style="flex:1">
      <select id="um-role-filter"><option value="all">all roles</option>
        <option value="admin">admins</option>
        <option value="researcher">researchers</option>
        <option value="rater">raters</option></select></div>
    <div id="um-list"></div></div>
  <div id="um-modal"></div>`));

  let search = "", roleFilter = "all";
  const list = document.getElementById("um-list");
  const modal = document.getElementById("um-modal");

  const patch = async (id, body) => {
    try { await api(`/api/auth/users/${id}`, {method: "PATCH", json: body}); }
    catch (e) { toast(e.message, "bad"); return false; }
    toast("updated"); return true;
  };

  const render = () => {
    const q = search.toLowerCase();
    const rows = users.filter(u =>
      (roleFilter === "all" || u.role === roleFilter) &&
      (!q || (u.username || "").toLowerCase().includes(q) ||
       (u.email || "").toLowerCase().includes(q)));
    if (!rows.length) {
      list.innerHTML = `<span class="dim">no users match</span>`;
      return;
    }
    list.innerHTML = `<table>
      <tr><th>user</th><th>role</th><th>tier</th><th>status</th>
        <th>last login</th><th></th></tr>
      ${rows.map(u => {
        const self = u.id === USER.id || u.username === USER.username;
        return `<tr>
        <td><div class="row"><span class="badge" style="width:26px;height:26px;
            display:inline-flex;align-items:center;justify-content:center;
            border-radius:50%">${esc((u.username || "?")[0].toUpperCase())}
          </span><div><b>${esc(u.username)}</b>${self
            ? ' <span class="dim">(you)</span>' : ""}
          <div class="dim" style="font-size:12px">${esc(u.email || "")}</div>
          </div></div></td>
        <td>${ROLE_ICON[u.role] || ""} <select data-role="${u.id}"
          ${self ? "disabled" : ""}>
          ${["rater", "researcher", "admin"].map(r =>
            `<option ${u.role === r ? "selected" : ""}>${r}</option>`)
            .join("")}</select></td>
        <td>${u.role === "rater" ? `<select data-tier="${u.id}"
            style="${TIER_STYLE[u.rater_tier] || ""}">
          ${["gold", "silver", "bronze"].map(t =>
            `<option ${(u.rater_tier || "bronze") === t ? "selected" : ""}>${t}
            </option>`).join("")}</select>`
          : `<span class="dim">N/A</span>`}</td>
        <td><button class="mini ${u.is_active ? "ok" : "bad"}"
          data-act="${u.id}" data-v="${u.is_active ? 0 : 1}"
          ${self ? "disabled" : ""}>${u.is_active ? "active" : "disabled"}
          </button></td>
        <td class="dim">${u.last_login ? when(u.last_login) : "never"}</td>
        <td><button class="mini bad" data-del="${u.id}"
          data-name="${esc(u.username)}" ${self ? "disabled" : ""}>🗑</button>
        </td></tr>`;
      }).join("")}</table>`;

    list.querySelectorAll("select[data-role]").forEach(s =>
      s.onchange = () => patch(s.dataset.role, {role: s.value}));
    list.querySelectorAll("select[data-tier]").forEach(s =>
      s.onchange = () => patch(s.dataset.tier, {rater_tier: s.value}));
    list.querySelectorAll("button[data-act]").forEach(b =>
      b.onclick = async () => {
        if (await patch(b.dataset.act, {is_active: +b.dataset.v}))
          go("users");
      });
    list.querySelectorAll("button[data-del]").forEach(b =>
      b.onclick = () => confirmDelete(b.dataset.del, b.dataset.name));
  };
  document.getElementById("um-search").oninput = (e) => {
    search = e.target.value; render();
  };
  document.getElementById("um-role-filter").onchange = (e) => {
    roleFilter = e.target.value; render();
  };
  render();

  // ---- delete confirmation (tsx:127-141 + confirm modal) -----------------
  function confirmDelete(id, name) {
    modal.innerHTML = "";
    modal.append(h(`<div style="position:fixed;inset:0;z-index:70;
        background:rgba(0,0,0,.5);display:flex;align-items:center;
        justify-content:center" id="um-del-bg">
      <div class="panel" style="max-width:380px;width:92%">
        <h2>Delete user?</h2>
        <div class="dim">This permanently removes <b>${esc(name)}</b> and
          cannot be undone. Their ratings remain attributed to the removed
          account id.</div>
        <div class="row" style="margin-top:12px">
          <button class="action bad" style="flex:1" id="um-del-yes">delete
          </button>
          <button class="mini" style="flex:1" id="um-del-no">cancel</button>
        </div></div></div>`));
    const close = () => modal.innerHTML = "";
    document.getElementById("um-del-no").onclick = close;
    document.getElementById("um-del-bg").onclick = (e) => {
      if (e.target.id === "um-del-bg") close();
    };
    document.getElementById("um-del-yes").onclick = async () => {
      try {
        await api(`/api/auth/users/${id}`, {method: "DELETE"});
        toast(`deleted ${name}`); close(); go("users");
      } catch (e) { toast(e.message, "bad"); }
    };
  }

  // ---- create-user modal (tsx:452-560) -----------------------------------
  document.getElementById("um-new").onclick = () => {
    modal.innerHTML = "";
    modal.append(h(`<div style="position:fixed;inset:0;z-index:70;
        background:rgba(0,0,0,.5);display:flex;align-items:center;
        justify-content:center" id="um-new-bg">
      <div class="panel" style="max-width:420px;width:92%">
        <h2>Create new user</h2>
        <label class="dim">username</label>
        <input id="um-nu" style="width:100%;margin-bottom:6px">
        <label class="dim">email</label>
        <input id="um-ne" type="email" style="width:100%;margin-bottom:6px">
        <label class="dim">password</label>
        <div class="row" style="margin-bottom:6px">
          <input id="um-np" type="password" style="flex:1">
          <button class="mini" id="um-eye">👁</button></div>
        <label class="dim">role</label>
        <select id="um-nr" style="width:100%">
          <option value="rater">rater</option>
          <option value="researcher">researcher</option>
          <option value="admin">admin</option></select>
        <div id="um-ntier-row"><label class="dim">rater tier</label>
        <select id="um-nt" style="width:100%">
          <option value="bronze">bronze</option>
          <option value="silver">silver</option>
          <option value="gold">gold</option></select></div>
        <div class="dim" style="font-size:12px;margin-top:6px">
          privileged roles are minted only through this admin endpoint —
          self-registration always creates raters</div>
        <div class="row" style="margin-top:10px">
          <button class="action" style="flex:1" id="um-create">create user
          </button>
          <button class="mini" style="flex:1" id="um-cancel">cancel</button>
        </div></div></div>`));
    const close = () => modal.innerHTML = "";
    document.getElementById("um-cancel").onclick = close;
    document.getElementById("um-new-bg").onclick = (e) => {
      if (e.target.id === "um-new-bg") close();
    };
    document.getElementById("um-eye").onclick = () => {
      const p = document.getElementById("um-np");
      p.type = p.type === "password" ? "text" : "password";
    };
    // tier applies to raters only (tsx:530-537)
    const roleSel = document.getElementById("um-nr");
    const tierRow = document.getElementById("um-ntier-row");
    roleSel.onchange = () =>
      tierRow.style.display = roleSel.value === "rater" ? "" : "none";
    document.getElementById("um-create").onclick = async () => {
      const [u, e2, p] = ["um-nu", "um-ne", "um-np"].map(i =>
        document.getElementById(i).value.trim());
      const role = roleSel.value;
      if (!u || !e2 || !p)
        return toast("username, email, password required", "warn");
      const body = {username: u, email: e2, password: p, role};
      if (role === "rater")
        body.rater_tier = document.getElementById("um-nt").value;
      try {
        await api("/api/auth/users", {json: body});
        toast(`created ${u} (${role})`); close(); go("users");
      } catch (err) { toast(err.message, "bad"); }
    };
  };
}
